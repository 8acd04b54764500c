"""Parameter server — the go/pserver + paddle/pserver rebuild (the port's
counterpart of ``paddle_tpu/distributed/pserver.py``).

The server is host code by design, in both packages, as the reference's
is CPU C++: parameters, gradients and optimizer state are numpy arrays
and the dense and lazy-sparse Adam/Adamax updates are numpy.  Where a
row update runs a registered optimizer op, it runs the port's own op on
CPU tensors made here with ``device="cpu"``; a server process never
initialises CUDA.  The client converts torch tensors to numpy at its
public methods (``core.scope.tensor_to_numpy``), so only numpy crosses
the wire, and the checkpoint is the JAX package's pickle: the two
packages' servers, clients and checkpoints interoperate.

Reference capabilities reproduced (SURVEY §L8):
* intra-parameter BLOCK sharding across N servers: each parameter is split
  into ~even row-range blocks assigned round-robin starting at the name
  hash (reference ``distribute_transpiler.py:106-145 split_dense_variable``
  + blockwise scatter/gather ``ParameterClient2.cpp:352``); small params
  stay whole on their hash server (client.go name-hash selection);
* concurrent scatter/gather: the client sends/fetches to all servers in
  parallel, serial per connection (``ParameterClient2.cpp:146
  sendParallel``);
* sync mode: barrier across num_trainers gradient sends, then one optimizer
  step server-side (ParameterServer2 addGradient :482 + doOperation :1269,
  ParameterUpdateMode ADD_GRADIENT);
* async mode: apply immediately per gradient (ASYNC_SGD);
* sparse updates: SelectedRows-style (rows, values) payloads
  (PSERVER_UPDATE_MODE_GET_PARAM_SPARSE) applied through the CONFIGURED
  optimizer with per-row state (go/pserver/optimizer.go:51 runs the full
  optimizer family on sparse sends; lazy semantics — only touched rows'
  moments advance);
* server-side optimizers: the trainer's update rules (ops/optimizer_ops.py)
  run here on the host — the analog of recv_op executing the optimize
  sub-block with a local Executor (recv_op.cc:100-143) and of the cgo
  paddle/optimizer library;
* checkpoint/restore with CRC32 + metadata in the coordination store
  (go/pserver/service.go:342 checkpoint, :175 LoadCheckpoint).
"""

import os
import pickle
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import time

import numpy as np
import torch

from . import rpc
from .store import InMemStore
from ..core.registry import get_op_impl
from ..core.scope import tensor_to_numpy
from ..observability import metrics as _obs


def assign_server(name, num_servers):
    """Deterministic param→server map (client.go name-hash selection)."""
    return zlib.crc32(name.encode()) % num_servers


def split_param(name, shape, num_servers, min_block_elems=8192):
    """Block plan for one parameter: tuple of ``(server, row0, row1)``.

    Splits along axis 0 into up to ``num_servers`` contiguous row ranges
    (within one row of even), assigned round-robin starting at the name
    hash so single-block params still spread.  Parameters smaller than
    2*min_block_elems (or with <2 rows) stay whole — the reference's
    min_block_size guard (``distribute_transpiler.py:106-145``).  The plan
    is a pure function of (name, shape, num_servers): every trainer
    computes the same plan with no coordination."""
    shape = tuple(int(s) for s in shape)
    rows = shape[0] if shape else 1
    elems = int(np.prod(shape)) if shape else 1
    base = assign_server(name, num_servers)
    nb = min(num_servers, rows, max(1, elems // min_block_elems))
    if nb <= 1:
        # whole-param form (row range None): scalars/0-d params can't be
        # row-sliced, and single-block params need no reassembly
        return ((base, None, None),)
    return tuple(
        ((base + b) % num_servers,
         b * rows // nb, (b + 1) * rows // nb)
        for b in range(nb)
    )


class _OptimizerState:
    """Per-parameter optimizer state + one update step, reusing the op
    implementations (sgd/momentum/adam/... from ops/optimizer_ops.py)."""

    def __init__(self, op_type="sgd", lr=0.01, attrs=None):
        self.op_type = op_type
        self.lr = np.asarray([lr], np.float32)
        self.attrs = dict(attrs or {})
        self.acc = {}

    def _ensure(self, name, shape):
        if name not in self.acc:
            init = 1.0 if name in ("Beta1Pow", "Beta2Pow") else 0.0
            s = (1,) if name in ("Beta1Pow", "Beta2Pow") else shape
            self.acc[name] = np.full(s, init, np.float32)
        return self.acc[name]

    _STATE_SLOTS = {
        "sgd": [],
        "momentum": [("Velocity", "VelocityOut")],
        "adagrad": [("Moment", "MomentOut")],
        "adam": [
            ("Moment1", "Moment1Out"), ("Moment2", "Moment2Out"),
            ("Beta1Pow", "Beta1PowOut"), ("Beta2Pow", "Beta2PowOut"),
        ],
        "adamax": [
            ("Moment", "MomentOut"), ("InfNorm", "InfNormOut"),
            ("Beta1Pow", "Beta1PowOut"),
        ],
        "adadelta": [
            ("AvgSquaredGrad", "AvgSquaredGradOut"),
            ("AvgSquaredUpdate", "AvgSquaredUpdateOut"),
        ],
        "rmsprop": [("MeanSquare", "MeanSquareOut"), ("Moment", "MomentOut")],
        "ftrl": [
            ("SquaredAccumulator", "SquaredAccumOut"),
            ("LinearAccumulator", "LinearAccumOut"),
        ],
        "decayed_adagrad": [("Moment", "MomentOut")],
        "proximal_gd": [],
        "proximal_adagrad": [("Moment", "MomentOut")],
    }

    def step(self, param, grad):
        """Dense update in plain numpy — the pserver is host code (the
        reference's is CPU C++).  The formulas mirror
        ops/optimizer_ops.py line for line; equivalence with the JAX
        package's server and with locally trained programs is pinned by
        tests/test_torch_distributed.py and tests/test_torch_transpiler.py."""
        if any(k.endswith("@rows") for k in self.acc):
            # dense and row-sparse adam/adamax track bias correction in
            # different state (scalar pow vs per-row pows); mixing them
            # on one parameter silently mis-scales updates — forbid it
            raise ValueError(
                f"parameter already updated through the sparse path "
                f"({self.op_type}); cannot mix dense step() with "
                f"step_rows() on one parameter")
        orig_dtype = np.asarray(param).dtype
        p = np.asarray(param, np.float32)
        g = np.asarray(grad, np.float32)
        lr = float(self.lr.reshape(-1)[0])
        a = self.attrs
        acc = self.acc
        t = self.op_type
        if t == "sgd":
            out = p - lr * g
        elif t == "momentum":
            mu = a.get("mu", 0.9)
            v = mu * self._ensure("Velocity", p.shape) + g
            if a.get("use_nesterov", False):
                out = p - (g + mu * v) * lr
            else:
                out = p - lr * v
            acc["Velocity"] = v
        elif t == "adagrad":
            m = self._ensure("Moment", p.shape) + g * g
            out = p - lr * g / (np.sqrt(m) + a.get("epsilon", 1e-6))
            acc["Moment"] = m
        elif t == "adam":
            b1, b2 = a.get("beta1", 0.9), a.get("beta2", 0.999)
            eps = a.get("epsilon", 1e-8)
            m1 = b1 * self._ensure("Moment1", p.shape) + (1 - b1) * g
            m2 = b2 * self._ensure("Moment2", p.shape) + (1 - b2) * g * g
            b1p = self._ensure("Beta1Pow", p.shape)
            b2p = self._ensure("Beta2Pow", p.shape)
            lr_t = lr * np.sqrt(1 - b2p * b2) / (1 - b1p * b1)
            out = p - lr_t * m1 / (np.sqrt(m2) + eps)
            acc["Moment1"], acc["Moment2"] = m1, m2
            acc["Beta1Pow"], acc["Beta2Pow"] = b1p * b1, b2p * b2
        elif t == "adamax":
            b1, b2 = a.get("beta1", 0.9), a.get("beta2", 0.999)
            eps = a.get("epsilon", 1e-8)
            m = b1 * self._ensure("Moment", p.shape) + (1 - b1) * g
            u = np.maximum(b2 * self._ensure("InfNorm", p.shape),
                           np.abs(g))
            b1p = self._ensure("Beta1Pow", p.shape) * b1
            out = p - (lr / (1 - b1p)) * m / (u + eps)
            acc["Moment"], acc["InfNorm"], acc["Beta1Pow"] = m, u, b1p
        elif t == "adadelta":
            rho, eps = a.get("rho", 0.95), a.get("epsilon", 1e-6)
            asg = rho * self._ensure("AvgSquaredGrad", p.shape) \
                + (1 - rho) * g * g
            upd = -np.sqrt(
                (self._ensure("AvgSquaredUpdate", p.shape) + eps)
                / (asg + eps)) * g
            asu = rho * acc["AvgSquaredUpdate"] + (1 - rho) * upd * upd
            out = p + upd
            acc["AvgSquaredGrad"], acc["AvgSquaredUpdate"] = asg, asu
        elif t == "decayed_adagrad":
            decay, eps = a.get("decay", 0.95), a.get("epsilon", 1e-6)
            m = decay * self._ensure("Moment", p.shape) \
                + (1 - decay) * g * g
            out = p - lr * g / (np.sqrt(m) + eps)
            acc["Moment"] = m
        elif t == "rmsprop":
            decay = a.get("decay", 0.9)
            eps = a.get("epsilon", 1e-10)
            mom_c = a.get("momentum", 0.0)
            ms = decay * self._ensure("MeanSquare", p.shape) \
                + (1 - decay) * g * g
            mom = mom_c * self._ensure("Moment", p.shape) \
                + lr * g / np.sqrt(ms + eps)
            out = p - mom
            acc["MeanSquare"], acc["Moment"] = ms, mom
        elif t == "ftrl":
            l1, l2 = a.get("l1", 0.0), a.get("l2", 0.0)
            lr_power = a.get("lr_power", -0.5)
            sq = self._ensure("SquaredAccumulator", p.shape)
            lin = self._ensure("LinearAccumulator", p.shape)
            new_sq = sq + g * g
            if lr_power == -0.5:
                sigma = (np.sqrt(new_sq) - np.sqrt(sq)) / lr
                denom = np.sqrt(new_sq) / lr + 2 * l2
            else:
                sigma = (np.power(new_sq, -lr_power)
                         - np.power(sq, -lr_power)) / lr
                denom = np.power(new_sq, -lr_power) / lr + 2 * l2
            new_lin = lin + g - sigma * p
            out = (np.clip(new_lin, -l1, l1) - new_lin) / denom
            acc["SquaredAccumulator"] = new_sq
            acc["LinearAccumulator"] = new_lin
        elif t in ("proximal_gd", "proximal_adagrad"):
            l1, l2 = a.get("l1", 0.0), a.get("l2", 0.0)
            if t == "proximal_adagrad":
                m = self._ensure("Moment", p.shape) + g * g
                acc["Moment"] = m
                lr_v = lr / np.sqrt(m)
            else:
                lr_v = lr
            prox = p - lr_v * g
            if l1 > 0:
                out = (np.sign(prox)
                       * np.maximum(np.abs(prox) - lr_v * l1, 0.0)
                       / (1.0 + lr_v * l2))
            else:
                out = prox / (1.0 + lr_v * l2)
        else:
            raise ValueError(f"unknown pserver optimizer {t!r}")
        # update math runs f32; the STORED dtype must not drift from
        # what init_param recorded (same contract as step_rows)
        return np.asarray(out, np.float32).astype(orig_dtype, copy=False)

    def _ensure_row_pow(self, name, n_rows):
        """Per-row beta-power vector [n_rows, 1] (init 1.0) for lazy
        sparse adam/adamax: each row's bias correction tracks how many
        times THAT row was touched."""
        key = name + "@rows"
        if key not in self.acc:
            self.acc[key] = np.ones((n_rows, 1), np.float32)
        return self.acc[key]

    def step_rows(self, param, rows, values):
        """Row-sparse update with full optimizer semantics, lazy mode:
        only the touched rows' moments/pows advance (the reference runs
        the configured optimizer on sparse sends — go/pserver/optimizer.go:51
        cgo into the C++ optimizer lib; ParameterServer2.cpp:1269
        doOperation).  Mutates ``param`` in place and returns it.

        Duplicate rows are merge-added first (SelectedRows merge
        semantics); negative rows (padding ids) are dropped."""
        param = np.asarray(param, np.float32)
        if not param.flags.writeable:
            # e.g. a read-only view that reached the server without a
            # pickle roundtrip — the in-place row update needs an owned
            # buffer
            param = param.copy()
        rows = np.asarray(rows)
        values = np.asarray(values, np.float32)
        valid = rows >= 0
        rows, values = rows[valid], values[valid]
        if rows.size == 0:
            return param
        uniq, inv = np.unique(rows, return_inverse=True)
        if uniq.size != rows.size:
            merged = np.zeros((uniq.size,) + values.shape[1:], np.float32)
            np.add.at(merged, inv, values)
            rows, values = uniq, merged
        lr = float(self.lr[0])
        a = self.attrs
        if self.op_type == "sgd":
            param[rows] -= lr * values
            return param
        if self.op_type in ("adam", "adamax"):
            # the op impls take SCALAR beta pows; rows touched different
            # numbers of times need per-row pows, so the row math lives
            # here — pinned to the dense path by
            # tests/test_torch_distributed.py (sparse-vs-dense equivalence)
            if "Beta1Pow" in self.acc:
                raise ValueError(
                    f"parameter already updated through the dense path "
                    f"({self.op_type}); cannot mix step_rows() with "
                    f"dense step() on one parameter")
            b1 = a.get("beta1", 0.9)
            b2 = a.get("beta2", 0.999)
            eps = a.get("epsilon", 1e-8)
            if self.op_type == "adam":
                m1 = self._ensure("Moment1", param.shape)
                m2 = self._ensure("Moment2", param.shape)
                b1p = self._ensure_row_pow("Beta1Pow", param.shape[0])
                b2p = self._ensure_row_pow("Beta2Pow", param.shape[0])
                m1[rows] = b1 * m1[rows] + (1 - b1) * values
                m2[rows] = b2 * m2[rows] + (1 - b2) * values * values
                b1p[rows] *= b1
                b2p[rows] *= b2
                lr_t = lr * np.sqrt(1 - b2p[rows]) / (1 - b1p[rows])
                param[rows] -= lr_t * m1[rows] / (np.sqrt(m2[rows]) + eps)
            else:
                m = self._ensure("Moment", param.shape)
                u = self._ensure("InfNorm", param.shape)
                b1p = self._ensure_row_pow("Beta1Pow", param.shape[0])
                m[rows] = b1 * m[rows] + (1 - b1) * values
                u[rows] = np.maximum(b2 * u[rows], np.abs(values))
                b1p[rows] *= b1
                param[rows] -= (lr / (1 - b1p[rows])) * m[rows] / (
                    u[rows] + eps)
            return param
        # pow-free optimizers: run the REGISTERED op impl on the row
        # slice with row-sliced state (same update rule, sliced view), on
        # CPU tensors made here: the server never touches a card
        impl = get_op_impl(self.op_type)

        def host(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device="cpu")

        ins = {"Param": host(param[rows]), "Grad": host(values),
               "LearningRate": host(self.lr)}
        slots = self._STATE_SLOTS[self.op_type]
        for in_name, _ in slots:
            ins[in_name] = host(self._ensure(in_name, param.shape)[rows])
        outs = impl.call(ins, self.attrs, None)
        for in_name, out_name in slots:
            if out_name in outs:
                self.acc[in_name][rows] = outs[out_name].numpy()
        param[rows] = outs["ParamOut"].numpy()
        return param

    def get_states(self):
        return {"acc": self.acc, "op_type": self.op_type, "lr": self.lr}

    def set_states(self, states):
        self.acc = states["acc"]
        self.op_type = states["op_type"]
        self.lr = states["lr"]


class ParameterServer:
    """One shard server (hosts the params assigned to its index)."""

    def __init__(self, index=0, num_trainers=1, sync=True, store=None,
                 checkpoint_dir=None, checkpoint_every_n_updates=0,
                 registry=None):
        self.index = index
        self.num_trainers = num_trainers
        self.sync = sync
        self.store = store or InMemStore()
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every_n_updates
        self.params = {}
        self.meta = {}
        self.opt = {}
        self._grad_acc = {}
        self._grad_count = {}
        self._updates = 0
        # per-param update versions for the delta-fetch protocol; the
        # random epoch makes versions from a restarted server compare
        # unequal to any the client cached (equality-based, not ordered)
        self._epoch = int.from_bytes(os.urandom(4), "little")
        self._versions = {}
        self._init_done = False
        self._lock = threading.Lock()
        self._barrier = threading.Condition(self._lock)
        self._reg = registry or _obs.get_registry()
        self._shard = str(index)
        self._last_update_time = time.time()
        if checkpoint_dir:
            self._maybe_recover()

    # -- telemetry ---------------------------------------------------------
    def _count(self, name, n=1):
        self._reg.counter(name, shard=self._shard).inc(n)

    def _update_param_gauges(self):
        self._reg.gauge("pserver.param_count", shard=self._shard).set(
            len(self.params))
        self._reg.gauge("pserver.param_bytes", shard=self._shard).set(
            sum(np.asarray(v).nbytes for v in self.params.values()))

    def metrics(self):
        """RPC surface for scraping this shard: parameter footprint,
        lifetime update/gradient counters, sync-barrier backlog, and the
        age of the last applied update (a stalled trainer fleet shows as
        a growing update age while pending grads sit at the barrier)."""
        with self._lock:
            reg = self._reg
            return {
                "shard": self.index,
                "param_count": len(self.params),
                "param_bytes": int(sum(
                    np.asarray(v).nbytes for v in self.params.values())),
                "updates_applied": self._updates,
                "grads_received": reg.value(
                    "pserver.grads_received", shard=self._shard),
                "sparse_grads_received": reg.value(
                    "pserver.sparse_grads_received", shard=self._shard),
                "pending_grad_params": len(self._grad_acc),
                "checkpoints_written": reg.value(
                    "pserver.checkpoints_written", shard=self._shard),
                "last_update_age_sec": time.time() - self._last_update_time,
            }

    # -- init (service.go InitParam:229 / FinishInitParams:260) ------------
    def init_param(self, name, value, optimizer="sgd", lr=0.01, attrs=None):
        with self._lock:
            if self._init_done:
                return False
            # own the buffer: with in-process servers (no pickle
            # roundtrip) np.asarray would alias the caller's array and
            # step_rows' in-place row updates would mutate it
            self.params[name] = np.array(value)
            self.opt[name] = _OptimizerState(optimizer, lr, attrs)
            return True

    def set_param_meta(self, name, shape, min_block_elems=8192):
        """Record a logical parameter's GLOBAL shape + the block-size
        knob its plan was built with (stored on the name-hash server) so
        every client — late-attaching or differently configured —
        rebuilds the SAME block plan.  First writer wins (matching
        init_param): a second trainer with a different knob must not
        re-route blocks the first already placed.  A server recovered
        from a pre-block-sharding checkpoint already stores the param
        WHOLE under its bare name — registering block meta for it would
        route every later send/fetch to block keys that don't exist, so
        refuse."""
        with self._lock:
            if self._init_done and name in self.params:
                return False  # param exists whole (recovered legacy data)
            self.meta.setdefault(name, {
                "shape": tuple(int(s) for s in shape),
                "min_block_elems": int(min_block_elems),
            })
        return True

    def get_param_meta(self, name):
        return self.meta.get(name)

    def finish_init_params(self):
        with self._lock:
            self._init_done = True
            self._update_param_gauges()
        return True

    def ready(self):
        return self._init_done

    # -- training (SendGrad:285 / GetParam:311) ----------------------------
    def send_grad(self, name, grad):
        grad = np.asarray(grad)
        self._count("pserver.grads_received")
        with self._barrier:
            if not self.sync:
                self.params[name] = self.opt[name].step(self.params[name], grad)
                self._versions[name] = self._versions.get(name, 0) + 1
                self._after_update()
                return True
            acc = self._grad_acc.get(name)
            self._grad_acc[name] = grad if acc is None else acc + grad
            self._grad_count[name] = self._grad_count.get(name, 0) + 1
            if self._grad_count[name] >= self.num_trainers:
                g = self._grad_acc.pop(name) / self.num_trainers
                self._grad_count[name] = 0
                self.params[name] = self.opt[name].step(self.params[name], g)
                self._versions[name] = self._versions.get(name, 0) + 1
                self._after_update()
                self._barrier.notify_all()
            else:
                # ADD_GRADIENT sync barrier: wait for the update
                gen = self._updates
                while self._grad_count.get(name, 0) != 0 and self._updates == gen:
                    self._barrier.wait(timeout=30.0)
            return True

    def send_sparse_grad(self, name, rows, values):
        """SelectedRows update (sparse pserver path) through the
        CONFIGURED optimizer with per-row state (lazy semantics)."""
        self._count("pserver.sparse_grads_received")
        with self._lock:
            orig_dtype = self.params[name].dtype
            updated = self.opt[name].step_rows(
                np.asarray(self.params[name], np.float32),
                rows, values)
            # the update math runs f32; the STORED dtype must not drift
            # from what init_param recorded
            self.params[name] = updated.astype(orig_dtype, copy=False)
            self._versions[name] = self._versions.get(name, 0) + 1
            self._after_update()
        return True

    def get_param(self, name):
        with self._lock:
            # the live buffer: RPC copies via pickle; the in-process
            # client copies at its call boundary (PServerClient._call)
            return self.params[name]

    def get_param_if_newer(self, name, known):
        """Delta-fetch RPC (the version check the reference's dense
        trainer lacks — it re-downloads every parameter every step,
        ``RemoteParameterUpdater.cpp`` finishBatch): returns
        ``(version, value)`` when the param changed since ``known``,
        ``(version, None)`` when it hasn't — one round trip either
        way."""
        with self._lock:
            cur = (self._epoch, self._versions.get(name, 0))
            if known is not None and tuple(known) == cur:
                return cur, None
            # copy: _call's in-process isolation only covers the bare
            # "get_param" method name; this value is tuple-nested and a
            # concurrent step_rows would otherwise mutate it under the
            # caller (RPC paths get isolation from pickle for free)
            return cur, np.array(self.params[name])

    def get_param_rows(self, name, rows):
        """Sparse fetch (GET_PARAM_SPARSE): only requested rows."""
        with self._lock:
            return self.params[name][np.asarray(rows)]

    def param_names(self):
        return sorted(self.params)

    # -- checkpoint (service.go:342; CRC + meta in store) ------------------
    def _after_update(self):
        self._updates += 1
        self._last_update_time = time.time()
        self._count("pserver.updates_applied")
        self._reg.gauge("pserver.pending_grad_params",
                        shard=self._shard).set(len(self._grad_acc))
        if (
            self.checkpoint_dir
            and self.checkpoint_every
            and self._updates % self.checkpoint_every == 0
        ):
            self.checkpoint()

    def checkpoint(self):
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.checkpoint_dir, f"pserver-{self.index}.ckpt")
        payload = pickle.dumps(
            {
                "params": self.params,
                "meta": self.meta,  # block-plan recovery for reattachers
                "opt": {k: o.get_states() for k, o in self.opt.items()},
                "updates": self._updates,
            }
        )
        with open(path + ".tmp", "wb") as f:
            f.write(payload)
        os.replace(path + ".tmp", path)
        self.store.put(
            f"pserver/{self.index}/checkpoint",
            {"path": path, "crc32": zlib.crc32(payload), "updates": self._updates},
        )
        self._count("pserver.checkpoints_written")
        return path

    def _maybe_recover(self):
        meta = self.store.get(f"pserver/{self.index}/checkpoint")
        if not meta or not os.path.exists(meta["path"]):
            return
        with open(meta["path"], "rb") as f:
            payload = f.read()
        if zlib.crc32(payload) != meta["crc32"]:
            raise IOError(f"pserver checkpoint CRC mismatch: {meta['path']}")
        state = pickle.loads(payload)
        self.params = state["params"]
        self.meta = state.get("meta", {})
        for k, s in state["opt"].items():
            o = _OptimizerState()
            o.set_states(s)
            self.opt[k] = o
        self._updates = state["updates"]
        self._init_done = True


class PServerClient:
    """Trainer-side client over N shard servers (go/pserver/client) with
    intra-parameter block sharding and concurrent multi-server
    scatter/gather (``ParameterClient2.cpp:146 sendParallel``, ``:352``
    blockwise send).

    Block plans are a pure function of (name, shape, num_servers)
    (``split_param``), so every trainer derives the same routing without
    coordination; shapes are learned at ``init_params`` (every trainer
    calls it; re-inits after ``finish_init_params`` are no-ops
    server-side) or lazily from a whole-param fetch.

    Concurrency model: parallel ACROSS servers, sequential per server
    connection, with every trainer enumerating blocks in the same sorted
    order — the same discipline that makes the sync ADD_GRADIENT barrier
    deadlock-free in the reference client."""

    def __init__(self, endpoints_or_servers, store=None,
                 min_block_elems=8192):
        self._shards = []
        for e in endpoints_or_servers:
            if isinstance(e, ParameterServer):
                self._shards.append(e)
            else:
                self._shards.append(rpc.Client(e))
        self.store = store
        self.min_block_elems = min_block_elems
        self._plans = {}
        self._fallback_plans = {}
        self._shapes = {}
        self._dtypes = {}
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, len(self._shards)))
        self._block_versions = {}
        self._no_delta_rpc = False
        self.last_delta_bytes = 0

    def close(self):
        """Release worker threads and RPC connections (long-running
        trainers that rebuild clients on reconnect must not leak)."""
        self._pool.shutdown(wait=False)
        for s in self._shards:
            if isinstance(s, rpc.Client):
                s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def _host(value):
        """The numpy form of a parameter, gradient or row-id value: a torch
        tensor (on any device) is copied to the host here, at the client's
        boundary, so nothing but numpy reaches a server."""
        if isinstance(value, torch.Tensor):
            return tensor_to_numpy(value)
        return np.asarray(value)

    def _call(self, shard, method, *args):
        target = self._shards[shard]
        if isinstance(target, ParameterServer):
            result = getattr(target, method)(*args)
            if method == "get_param":
                # isolate in-process callers from the server's live
                # buffer (step_rows updates rows in place); RPC paths
                # get this isolation from pickle for free
                result = np.array(result)
            return result
        return target.call(method, *args)

    def _shard_of(self, name):
        return assign_server(name, len(self._shards))

    # -- block plumbing ----------------------------------------------------
    def _plan(self, name, shape=None):
        """Block plan for ``name``.  Without a shape in hand, recover it
        from the name-hash server's param meta (registered at
        init_params) — the late-attach path; if the servers predate
        block sharding (no meta), fall back to a single whole-param
        block on the hash server."""
        plan = self._plans.get(name)
        if plan is not None:
            return plan
        if name in self._fallback_plans:
            # legacy servers hold the param whole and can never grow
            # meta — honor the cached fallback on every path (a shape in
            # hand doesn't change what the servers store)
            return self._fallback_plans[name]
        # the server-recorded meta (first initializer's shape + knob)
        # always wins over this client's local config, so differently-
        # configured clients never derive divergent block layouts
        meta, legacy = self._meta_lookup(name)
        if meta is not None:
            plan = split_param(name, meta["shape"], len(self._shards),
                               meta["min_block_elems"])
            self._plans[name] = plan
            self._shapes[name] = tuple(meta["shape"])
            return plan
        if legacy:
            # pre-block-sharding servers hold params WHOLE under their
            # bare name (even when a shape is in hand, splitting would
            # route to block keys no server stores); they can never grow
            # meta, so the fallback is cached
            plan = ((self._shard_of(name), None, None),)
            self._fallback_plans[name] = plan
            return plan
        if shape is not None:
            # modern servers, meta not registered yet (racing the
            # initializer): provisional local-knob plan, NOT cached —
            # the next call re-validates against meta
            return split_param(name, shape, len(self._shards),
                               self.min_block_elems)
        # no meta yet and no shape: provisional whole-param, uncached
        return ((self._shard_of(name), None, None),)

    def _set_meta_safe(self, server, name, shape):
        """-> True registered / False server refused (recovered legacy
        data stored whole) / None legacy server without meta support."""
        try:
            return self._call(server, "set_param_meta", name, shape,
                              self.min_block_elems)
        except AttributeError:
            return None  # legacy server: no meta support, plans stay local
        except RuntimeError as e:
            if "AttributeError" not in str(e):
                raise
            return None

    def _meta_lookup(self, name):
        """-> (meta-or-None, is_legacy_server)."""
        try:
            return self._call(self._shard_of(name), "get_param_meta",
                              name), False
        except AttributeError:
            return None, True  # pre-block-sharding in-process server
        except RuntimeError as e:
            # rpc wraps remote errors; only a missing method means a
            # legacy server — transport failures must surface
            if "AttributeError" not in str(e):
                raise
            return None, True

    def _warm_plans(self, names):
        """Batch the meta probes for uncached names through the parallel
        fan-out, so neither init_params nor a late-attach client's first
        send/fetch pays one sequential RTT per parameter."""
        todo = [n for n in names
                if n not in self._plans and n not in self._fallback_plans]
        if not todo:
            return
        probes = self._per_server([
            (self._shard_of(n), n, (lambda n=n: self._meta_lookup(n)))
            for n in todo
        ])
        for n, (meta, legacy) in probes.items():
            if meta is not None:
                self._plans[n] = split_param(
                    n, meta["shape"], len(self._shards),
                    meta["min_block_elems"])
                self._shapes[n] = tuple(meta["shape"])
            elif legacy:
                self._fallback_plans[n] = (
                    (self._shard_of(n), None, None),)

    @staticmethod
    def _block_key(name, plan, bi):
        return name if len(plan) == 1 else f"{name}#blk{bi}"

    def _per_server(self, items):
        """items: iterable of (server, fn_args...) -> run each server's
        list sequentially (in order), servers concurrently.  Returns
        {key: result} merged from all servers."""
        by_server = {}
        for server, key, call in items:
            by_server.setdefault(server, []).append((key, call))

        def run(server):
            return [(key, call()) for key, call in by_server[server]]

        out = {}
        futs = [self._pool.submit(run, s) for s in sorted(by_server)]
        for f in futs:
            for key, result in f.result():
                out[key] = result
        return out

    # -- public API --------------------------------------------------------
    def init_params(self, named_params, optimizer="sgd", lr=0.01, attrs=None):
        names = sorted(named_params)
        # phase 0: one PARALLEL meta probe over all params (a possibly
        # earlier initializer's plans must win; serial per-param RPCs
        # here would add P x RTT to startup)
        self._warm_plans(names)
        jobs = []
        for name in names:
            value = self._host(named_params[name])
            if (name not in self._plans
                    and name not in self._fallback_plans):
                self._plans[name] = split_param(
                    name, value.shape, len(self._shards),
                    self.min_block_elems)
            plan = self._plan(name)
            self._shapes[name] = tuple(value.shape)
            self._dtypes[name] = value.dtype
            # meta rides the parallel fan-out with the blocks
            jobs.append((self._shard_of(name), f"{name}@meta", (
                lambda s=self._shard_of(name), n=name,
                sh=tuple(value.shape): self._set_meta_safe(s, n, sh))))
            for bi, (server, r0, r1) in enumerate(plan):
                key = self._block_key(name, plan, bi)
                blk = value if r0 is None else value[r0:r1]
                jobs.append((server, key, (
                    lambda s=server, k=key, b=np.asarray(blk): self._call(
                        s, "init_param", k, b, optimizer, lr, attrs))))
        results = self._per_server(jobs)
        for name in names:
            if results.get(f"{name}@meta") is False:
                # the server refused block meta: it holds this param
                # WHOLE from a pre-block-sharding checkpoint — route
                # whole, not to block keys that don't exist
                self._plans.pop(name, None)
                self._fallback_plans[name] = (
                    (self._shard_of(name), None, None),)
        # post-register validation: if another initializer with a
        # DIFFERENT block-size knob raced us, set_param_meta's
        # first-writer-wins means the authoritative plan may not be the
        # one we just cached — fail loudly rather than route blocks to a
        # divergent layout forever
        checks = self._per_server([
            (self._shard_of(n), n, (lambda n=n: self._meta_lookup(n)))
            for n in names
        ])
        for n, (meta, _legacy) in checks.items():
            if meta is None:
                continue
            authoritative = split_param(n, meta["shape"],
                                        len(self._shards),
                                        meta["min_block_elems"])
            if authoritative != self._plans.get(n, authoritative):
                raise ValueError(
                    f"concurrent init_params with mismatched "
                    f"min_block_elems for {n!r}: this client built "
                    f"{self._plans[n]} but the registered meta implies "
                    f"{authoritative} — configure every trainer's "
                    f"PServerClient with the same min_block_elems")
        for i in range(len(self._shards)):
            self._call(i, "finish_init_params")

    def send_grads(self, named_grads):
        self._warm_plans(sorted(named_grads))
        jobs = []
        for name in sorted(named_grads):
            g = self._host(named_grads[name])
            plan = self._plan(name, g.shape)
            for bi, (server, r0, r1) in enumerate(plan):
                key = self._block_key(name, plan, bi)
                blk = g if r0 is None else g[r0:r1]
                jobs.append((server, key, (
                    lambda s=server, k=key, b=np.asarray(blk): self._call(
                        s, "send_grad", k, b))))
        self._per_server(jobs)

    def _route_rows(self, name, rows):
        """Shared row→block routing for the sparse paths: returns
        ``(plan, [(server, key, local_rows, mask)])`` with every
        non-negative row covered by exactly one block, raising IndexError
        for rows outside the table (negative rows = padding, dropped by
        design — same contract as the single-server path)."""
        plan = self._plan(name)
        routed = []
        covered = rows < 0
        for bi, (server, r0, r1) in enumerate(plan):
            key = self._block_key(name, plan, bi)
            if r0 is None:
                routed.append((server, key, rows, None))
                covered |= True
            else:
                m = (rows >= r0) & (rows < r1)
                covered |= m
                if m.any():
                    routed.append((server, key, rows[m] - r0, m))
        if not np.all(covered):
            raise IndexError(
                f"rows {rows[~covered]} outside every block of {name!r} "
                f"(table rows: 0..{plan[-1][2]})")
        return plan, routed

    def send_sparse_grad(self, name, rows, values):
        rows = self._host(rows)
        values = self._host(values)
        _, routed = self._route_rows(name, rows)
        self._per_server([
            (server, key, (
                lambda s=server, k=key, r=local_rows,
                v=(values if mask is None else values[mask]): self._call(
                    s, "send_sparse_grad", k, r, v)))
            for server, key, local_rows, mask in routed
        ])

    def get_params(self, names):
        self._warm_plans(sorted(names))
        jobs = []
        metas = {}
        for name in sorted(names):
            plan = self._plan(name)
            metas[name] = plan
            for bi, (server, r0, r1) in enumerate(plan):
                key = self._block_key(name, plan, bi)
                jobs.append((server, key, (
                    lambda s=server, k=key: self._call(s, "get_param", k))))
        got = self._per_server(jobs)
        out = {}
        for name in names:
            plan = metas[name]
            blocks = [got[self._block_key(name, plan, bi)]
                      for bi in range(len(plan))]
            out[name] = (blocks[0] if len(blocks) == 1
                         else np.concatenate(blocks, axis=0))
        return out

    def get_params_delta(self, names):
        """Conditional dense fetch: every block is probed with the
        version this client last saw (``get_param_if_newer``) and only
        changed blocks move; names with NO changed block are omitted
        from the result entirely.  ``last_delta_bytes`` records the
        payload actually transferred — when the servers are idle it
        drops to 0 (the reference dense trainer re-downloads O(params)
        per step unconditionally).  Against legacy servers without the
        RPC the client degrades to a full ``get_params`` (same
        missing-method discipline as ``_meta_lookup``)."""
        if self._no_delta_rpc:
            out = self.get_params(names)
            self.last_delta_bytes = sum(
                np.asarray(v).nbytes for v in out.values())
            return out
        self._warm_plans(sorted(names))
        jobs = []
        metas = {}
        for name in sorted(names):
            plan = self._plan(name)
            metas[name] = plan
            for bi, (server, r0, r1) in enumerate(plan):
                key = self._block_key(name, plan, bi)
                known = self._block_versions.get(key)
                jobs.append((server, key, (
                    lambda s=server, k=key, kn=known: self._call(
                        s, "get_param_if_newer", k, kn))))
        try:
            got = self._per_server(jobs)
        except AttributeError:
            self._no_delta_rpc = True
            return self.get_params_delta(names)
        except RuntimeError as e:
            if "AttributeError" not in str(e):
                raise
            self._no_delta_rpc = True
            return self.get_params_delta(names)
        out = {}
        nbytes = 0
        fills = []  # unchanged blocks of names that DID change elsewhere
        parts = {}
        new_versions = {}
        for name in names:
            plan = metas[name]
            blocks = []
            changed = False
            for bi in range(len(plan)):
                key = self._block_key(name, plan, bi)
                ver, val = got[key]
                new_versions[key] = ver
                if val is not None:
                    changed = True
                    nbytes += np.asarray(val).nbytes
                blocks.append((bi, key, val))
            if not changed:
                continue
            parts[name] = blocks
            for bi, key, val in blocks:
                if val is None:
                    fills.append((plan[bi][0], key, (
                        lambda s=plan[bi][0], k=key: self._call(
                            s, "get_param", k))))
        # mixed updates within one name are possible (per-block
        # versions); fetch the unchanged blocks through the SAME
        # parallel fan-out rather than one serial RTT each
        filled = self._per_server(fills) if fills else {}
        for name, blocks in parts.items():
            vals = []
            for bi, key, val in blocks:
                if val is None:
                    val = filled[key]
                    nbytes += np.asarray(val).nbytes
                vals.append(val)
            out[name] = (vals[0] if len(vals) == 1
                         else np.concatenate(vals, axis=0))
        # commit the observed versions only now, with every value safely
        # in hand: recording them before the fill fetch would turn a
        # transport failure into a permanently-stale client (the retry
        # would be told "unchanged" for an update it never received)
        self._block_versions.update(new_versions)
        self.last_delta_bytes = nbytes
        return out

    def get_param_rows(self, name, rows):
        """Sparse row fetch (prefetch path): rows routed to their block's
        server, results reassembled in input order.  Rows outside every
        block (beyond the table) raise rather than returning garbage."""
        rows = self._host(rows)
        if rows.size and (rows < 0).any():
            raise IndexError(
                f"negative row ids in get_param_rows({name!r}): padding "
                f"ids are only meaningful for gradient sends")
        plan = self._plan(name)
        if len(plan) == 1 and plan[0][1] is None:
            return self._call(plan[0][0], "get_param_rows", name, rows)
        if rows.size == 0:
            shape = self._shapes.get(name)
            return np.zeros((0,) + tuple(shape[1:] if shape else ()),
                            self._dtypes.get(name, np.float32))
        _, routed = self._route_rows(name, rows)
        got = self._per_server([
            (server, key, (
                lambda s=server, k=key, r=local_rows: self._call(
                    s, "get_param_rows", k, r)))
            for server, key, local_rows, mask in routed
        ])
        first = next(iter(got.values()))
        out = np.zeros((rows.size,) + np.asarray(first).shape[1:],
                       np.asarray(first).dtype)
        for server, key, local_rows, mask in routed:
            out[mask if mask is not None else slice(None)] = got[key]
        return out
