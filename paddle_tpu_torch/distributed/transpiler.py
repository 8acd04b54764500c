"""DistributeTranspiler — split one program into trainer/pserver halves
(the port's counterpart of ``paddle_tpu/distributed/transpiler.py``).

Reference: fluid/distribute_transpiler.py:81 — params/grads split into
blocks round-robin over pserver endpoints (:106-145), trainer program gets
send_op on gradients (get_trainer_program:252), pserver program gets recv_op
plus the optimize sub-block (get_pserver_program:434) executed after N
trainers deliver grads (recv_op.cc:100-143).

The trainer half is the forward+backward prefix of the program (the
Executor's autograd leaves ``<param>@GRAD`` fetchable); the pserver half
is the parameter shard assignment plus the optimizer op types and attrs
taken from the optimize ops — the ParameterServer runs the same update
rule on the host.  ``DistributedTrainer`` is the send/recv loop (the
send_op / recv_op pair) over the RPC clients.

Where the card comes in: the trainer's parameters stay in the scope as
tensors on the Executor's device, and are written IN PLACE — prefetched
embedding rows by ``index_copy_`` of the valid rows into the table (only
``[rows, emb]`` goes host to device, never the table), fresh dense
parameters by ``copy_`` into the existing tensor (its device and dtype
kept).  The gradients reach the host through the step's one
``Executor.run(..., return_numpy=True)``.  The RPC worker threads (the
pipelined round trip, the per-parameter fan-out) handle host numpy only
and never touch a CUDA tensor; the installs run on the calling thread.
"""

import copy
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .pserver import PServerClient, assign_server
from ..core.program import GRAD_SUFFIX
from ..core.scope import global_scope, tensor_from_numpy, tensor_to_numpy

_OPTIMIZE_OPS = {
    "sgd", "momentum", "adam", "adamax", "adagrad", "adadelta",
    "decayed_adagrad", "rmsprop", "ftrl", "proximal_gd", "proximal_adagrad",
}


def _host(value):
    """A feed value as numpy (a tensor is copied off its device)."""
    if isinstance(value, torch.Tensor):
        return tensor_to_numpy(value)
    return np.asarray(value)


class DistributeTranspiler:
    def __init__(self):
        self._transpiled = False

    def transpile(self, program, pservers, trainers=1, trainer_id=0):
        """pservers: endpoint list (or count).  Extract the optimize-op info
        and compute the param→pserver assignment."""
        self.program = program
        self.trainers = trainers
        self.trainer_id = trainer_id
        if isinstance(pservers, int):
            self.endpoints = list(range(pservers))
        elif isinstance(pservers, str):
            self.endpoints = pservers.split(",")
        else:
            self.endpoints = list(pservers)
        n = len(self.endpoints)

        block = program.global_block()
        bw = block.backward_index
        if bw is None:
            raise ValueError(
                "transpile needs a program with append_backward applied")
        self.optimize_info = {}
        for op in block.ops[bw:]:
            if op.type in _OPTIMIZE_OPS:
                pname = op.inputs["Param"][0]
                self.optimize_info[pname] = {
                    "op_type": op.type,
                    "attrs": dict(op.attrs),
                }
        self.param_assignment = {
            p: assign_server(p, n) for p in self.optimize_info
        }
        self._transpiled = True
        return self

    def get_trainer_program(self):
        """Forward+backward only: strip the optimizer tail; grads stay
        fetchable as <param>@GRAD."""
        prog = copy.deepcopy(self.program)
        block = prog.global_block()
        bw = block.backward_index
        kept = [op for op in block.ops[bw:] if op.type not in _OPTIMIZE_OPS]
        block.ops = block.ops[:bw] + kept
        return prog

    def get_pserver_config(self, endpoint):
        """Which params this pserver hosts + their update rules."""
        idx = (self.endpoints.index(endpoint)
               if endpoint in self.endpoints else endpoint)
        return {
            p: self.optimize_info[p]
            for p, a in self.param_assignment.items()
            if a == idx
        }


class DistributedTrainer:
    """The send/recv loop (send_op.cc:35 / recv_op.cc:86 analog): run the
    trainer program, push grads, pull fresh params into the Scope.

    ``sparse_params={param_name: ids_feed_name}`` routes those parameters
    (embedding tables) through the sparse path: before each step the rows
    the batch will touch are PREFETCHED from the servers
    (``GradientMachine::prefetch`` + ``SparseRemoteParameterUpdater``,
    reference ``RemoteParameterUpdater.h:265``) and written into the
    table in place, and after the step only the touched gradient rows are
    sent (``send_sparse_grad``), applied server-side by the configured
    optimizer with per-row state.

    ``mode="pipelined"`` runs step N's send/fetch on one ordered worker
    thread while step N+1 computes (the ConcurrentRemoteParameterUpdater
    design, reference ``RemoteParameterUpdater.h:180``): parameters are
    one round trip stale and the step takes ~max(compute, RPC)."""

    def __init__(self, transpiler, executor, pserver_endpoints_or_servers,
                 learning_rate=0.01, sparse_params=None, mode="serial"):
        if mode not in ("serial", "pipelined"):
            raise ValueError(f"mode must be serial|pipelined, got {mode!r}")
        self.t = transpiler
        self.exe = executor
        self.mode = mode
        self.client = PServerClient(pserver_endpoints_or_servers)
        self.trainer_program = transpiler.get_trainer_program()
        self.param_names = sorted(transpiler.optimize_info)
        self.sparse = dict(sparse_params or {})
        unknown = set(self.sparse) - set(self.param_names)
        if unknown:
            raise ValueError(f"sparse_params not in program: {unknown}")
        self.dense_names = [p for p in self.param_names
                            if p not in self.sparse]
        self.lr = learning_rate
        self._pipe_pool = (ThreadPoolExecutor(max_workers=1)
                           if mode == "pipelined" else None)
        self._pending = None
        self.last_step_fetch_bytes = 0
        # where the last train_step's wall went, in seconds: "rows" (the
        # prefetch and the row installs), "compute" (Executor.run with
        # the gradient fetch), "exchange" (the round trip, or in
        # pipelined mode the wait for the previous one), "install" (the
        # dense parameters)
        self.last_step_seconds = {}
        # cumulative counter: exact accounting across pipelined steps
        # (last_step_fetch_bytes lags one step in pipelined mode)
        self.total_fetch_bytes = 0
        # per-param prefetch/send fan-out pool (distinct from the
        # client's per-server pool, so nesting cannot deadlock)
        self._sparse_pool = (
            ThreadPoolExecutor(max_workers=len(self.sparse))
            if self.sparse else None)
        # sparse params fetch only the TOUCHED gradient rows: a gather of
        # <p>@GRAD by a fed row-id vector appended to the trainer program
        # (it runs after the backward, on the Executor's device), so host
        # traffic is O(rows) not O(vocab).  The ids are padded with -1,
        # which the gather wraps to the LAST row (as jnp.take does); that
        # row's value is dropped server-side because its id is negative.
        block = self.trainer_program.global_block()
        self._grad_fetch = []
        for p in self.param_names:
            if p not in self.sparse:
                self._grad_fetch.append(p + GRAD_SUFFIX)
                continue
            pshape = tuple(block.var(p).shape)
            rows_var = block.create_var(
                name=f"{p}@ROWIDS", shape=(-1,), dtype="int64",
                is_data=True, stop_gradient=True)
            out_var = block.create_var(
                name=f"{p}@GRADROWS", shape=(-1,) + pshape[1:],
                dtype="float32", stop_gradient=True)
            block.append_op(
                "gather",
                inputs={"X": [p + GRAD_SUFFIX], "Index": [rows_var.name]},
                outputs={"Out": [out_var.name]})
            self._grad_fetch.append(out_var.name)

    def close(self):
        """Release the client's worker pool and RPC connections."""
        if self._pending is not None:
            try:
                self.flush()
            except Exception:
                pass
        if self._pipe_pool is not None:
            self._pipe_pool.shutdown(wait=False)
        if self._sparse_pool is not None:
            self._sparse_pool.shutdown(wait=False)
        self.client.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _install(self, fresh, nbytes):
        """Write fetched dense parameters into their scope tensors in place
        (on the calling thread: the worker never touches the card)."""
        t0 = time.perf_counter()
        scope = global_scope()
        for name, value in fresh.items():
            scope.get(name).copy_(tensor_from_numpy(value))
        self.last_step_fetch_bytes = nbytes
        self.total_fetch_bytes += nbytes
        self.last_step_seconds["install"] = time.perf_counter() - t0

    def flush(self):
        """Drain the in-flight send/fetch (pipelined mode) and install
        the freshest params into the scope.  Call before checkpointing
        or evaluating so the local view is current."""
        if self._pending is None:
            return
        fut, self._pending = self._pending, None
        self._install(*fut.result())

    def init_params_on_pservers(self):
        """Trainer 0 pushes initial values (reference: trainer 0 runs the
        startup program then InitParam RPCs)."""
        scope = global_scope()
        named = {p: tensor_to_numpy(scope.get(p)) for p in self.param_names}
        first = self.param_names[0] if self.param_names else None
        opt = self.t.optimize_info[first]["op_type"] if first else "sgd"
        attrs = self.t.optimize_info[first]["attrs"] if first else {}
        self.client.init_params(named, optimizer=opt, lr=self.lr, attrs=attrs)

    def _batch_rows(self, feed, feed_name):
        ids = np.unique(_host(feed[feed_name]).ravel().astype(np.int64))
        return ids[ids >= 0]

    def _device_feed(self, feed):
        """The feed on the Executor's card: each host array through pinned
        memory by a non-blocking copy (no host sync); unchanged on the
        CPU."""
        dev = self.exe.device
        if dev.type != "cuda":
            return feed
        out = {}
        for name, value in feed.items():
            if not isinstance(value, torch.Tensor):
                value = tensor_from_numpy(value)
            if value.device != dev:
                value = value.pin_memory().to(dev, non_blocking=True)
            out[name] = value
        return out

    def train_step(self, feed, extra_fetch=()):
        """One iteration: prefetch sparse rows -> local fwd/bwd -> send
        dense grads + sparse grad rows -> recv dense params.  Returns the
        ``extra_fetch`` values as numpy."""
        t0 = time.perf_counter()
        self.last_step_seconds = {"install": 0.0}
        scope = global_scope()
        feed = dict(feed)
        padded_ids = {}
        prefetch = {}
        for pname, feed_name in self.sparse.items():
            ids = self._batch_rows(feed, feed_name)
            # a fixed-length padded id vector (pad = -1), the feed's
            # length, as in the JAX package
            padded = np.full(int(_host(feed[feed_name]).size), -1, np.int64)
            padded[:ids.size] = ids
            padded_ids[pname] = padded
            feed[f"{pname}@ROWIDS"] = padded
            if ids.size == 0:  # all-padding batch for this slot
                continue
            # all params' row fetches in flight together (each fans out
            # across servers inside the client)
            prefetch[pname] = (ids, self._sparse_pool.submit(
                self.client.get_param_rows, pname, ids))
        for pname, (ids, fut) in prefetch.items():
            # the valid rows only (the padding is masked off, never
            # routed), written into the table where it lies: [rows, emb]
            # crosses to the device, the table keeps its storage
            table = scope.get(pname)
            rows = torch.from_numpy(ids).to(table.device)
            table.index_copy_(0, rows, tensor_from_numpy(fut.result()).to(
                table.device, table.dtype))
        t1 = time.perf_counter()
        block = self.trainer_program.global_block()
        fetch_vars = ([block.var(n) for n in self._grad_fetch]
                      + list(extra_fetch))
        vals = self.exe.run(self.trainer_program,
                            feed=self._device_feed(feed),
                            fetch_list=fetch_vars, return_numpy=True)
        t2 = time.perf_counter()
        grads = dict(zip(self.param_names, vals[:len(self.param_names)]))
        dense_grads = {n: grads[n] for n in self.dense_names}
        sparse_jobs = [
            (pname, padded_ids[pname], grads[pname])
            for pname in self.sparse
            if (padded_ids[pname] >= 0).sum() > 0
        ]

        def _round_trip():
            # host numpy only: this runs on the pipelined worker
            self.client.send_grads(dense_grads)
            sends = [
                self._sparse_pool.submit(self.client.send_sparse_grad,
                                         pname, ids_, g_)
                for pname, ids_, g_ in sparse_jobs
            ]
            for f in sends:
                f.result()
            # conditional fetch: unchanged params move zero bytes; the
            # bytes ride WITH the result (the shared
            # client.last_delta_bytes races the next round trip)
            fresh = self.client.get_params_delta(self.dense_names)
            return fresh, self.client.last_delta_bytes

        if self.mode == "pipelined":
            # double buffer: submit THIS step's round trip, then wait for
            # the PREVIOUS one, which had our whole compute to finish.
            # Step N computes on the params installed at the end of step
            # N-1, the result of round trip N-2 (pipelined async-SGD
            # delay; serial mode is the zero-staleness path).  The
            # single-worker pool keeps sends ordered.
            prev, self._pending = (
                self._pending, self._pipe_pool.submit(_round_trip))
            if prev is not None:
                self._install(*prev.result())
        else:
            self._install(*_round_trip())
        sec = self.last_step_seconds
        sec.update(rows=t1 - t0, compute=t2 - t1,
                   exchange=time.perf_counter() - t2 - sec["install"])
        return vals[len(self.param_names):]
