"""The port's checkpoint format (``paddle_tpu_torch.io``) against the JAX
package's, on the CPU.

The 2-layer GPT of ``tests/test_torch_trainer.py`` (vocab 256, d_model
64, 2 heads, t=64, batch 2, dropout 0, fused head) in f32 and bf16:

* a JAX-written checkpoint (f32 and bf16) loads into the port, every
  tensor bit-equal to the reference's, and two more steps in the port
  give the reference's own continuation within ``ORACLE_TOL`` (2e-4
  relative in f32, 2e-2 in bf16 — the fused head's tolerances);
* a port-written f32 checkpoint loads into the JAX package bit-equal, and
  two more steps there agree with the port's within ``ORACLE_TOL``.  (A
  bf16 checkpoint does not load back into the JAX package at all: its
  own ``load_vars`` hands ``np.load``'s ``|V2`` words to ``jnp.asarray``,
  which refuses them — a reference caveat, ROADMAP C; so that direction
  is tested in f32);
* the port's bf16 ``.npy`` files are byte-identical to the JAX package's
  for the same values, and the manifests equal;
* a wrong CRC and a missing ``__done0__`` raise; a checkpoint written by
  two JAX processes (``.shard<p>.npz``) assembles densely;
* ``AsyncCheckpointer`` writes the values of the moment ``save()`` was
  called, though the Executor updates them in place right after (on the
  CPU here; on the card in ``tests/test_torch_cuda_kernels.py``);
* the sidecar: the JAX package reads the port's (``rng_kind`` is one
  more field); the port refuses a JAX threefry key for a program that
  draws random numbers and skips it for one that does not.
"""

import os
import pickle
import shutil

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu import io as jio
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.resilience import checkpoint as tckpt
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

VOCAB, T, BATCH = 256, 64, 2


@pytest.fixture(autouse=True, scope="module")
def _no_tune_cache(tmp_path_factory):
    """The reference reads tuned attention geometry from its tune cache;
    a fresh cache path holds none, so both packages build defaults."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tuned.json"))
        yield


def _cfg(dtype, dropout=0.0):
    return dict(vocab_size=VOCAB, n_layer=2, n_head=2, d_model=64,
                max_len=T, dropout_rate=dropout, dtype=dtype,
                fused_head=True, learning_rate=1e-3)


def _build(pkg, model, cfg):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        out = model.build(**cfg)
    return main, startup, out


def _feeds(n=4, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = (rng.integers(0, VOCAB, (BATCH, 1)) + np.arange(T)) % VOCAB
        out.append({"tokens": toks.astype(np.int64),
                    "labels": ((toks + 1) % VOCAB).astype(np.int64)})
    return out


def _words(a):
    """Raw bits of an array for bit-equality (bf16 as 16-bit words)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and \
        a.dtype.kind in "Vf" else a


class _Jax:
    """One compiled reference program: startup, two steps, a checkpoint
    (its own writer), two more steps."""

    def __init__(self, dtype, ckdir):
        self.ckdir = ckdir
        self.main, startup, out = _build(pt, jtr, _cfg(dtype))
        self.scope = pt.Scope()
        self.exe = pt.Executor(pt.CPUPlace())
        self.fetch = [out["avg_cost"].name]
        self.names = [v.name for v in self.main.persistable_vars()]
        feeds = _feeds()
        with pt.core.scope.scope_guard(self.scope):
            self.exe.run(startup)
            self.init = self.state()
            for f in feeds[:2]:
                self.exe.run(self.main, feed=f, fetch_list=self.fetch)
            jio.save_persistables(self.exe, str(ckdir), self.main)
            self.saved = self.state()
            self.cont = [self.step(f) for f in feeds[2:]]

    def state(self):
        return {n: np.asarray(self.scope.find_var(n)) for n in self.names}

    def step(self, feed):
        out, = self.exe.run(self.main, feed=feed, fetch_list=self.fetch)
        return float(np.asarray(out, np.float32).ravel()[0])


@pytest.fixture(scope="module")
def jax_f32(tmp_path_factory):
    return _Jax("float32", tmp_path_factory.mktemp("jax_f32"))


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    return _Jax("bfloat16", tmp_path_factory.mktemp("jax_bf16"))


def _port(dtype, scope):
    main, startup, out = _build(tpt, ttr, _cfg(dtype))
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)            # @RNG@ and the like
    return main, exe, [out["avg_cost"].name]


@pytest.mark.parametrize("which", ["jax_f32", "jax_bf16"])
def test_jax_checkpoint_continues_in_the_port(which, request, tmp_path):
    ref = request.getfixturevalue(which)
    dtype = "float32" if which == "jax_f32" else "bfloat16"
    ckdir = tmp_path / "ck"
    shutil.copytree(ref.ckdir, ckdir)
    scope = tpt.Scope()
    main, exe, fetch = _port(dtype, scope)
    with tpt.scope_guard(scope):
        tio.load_persistables(exe, str(ckdir), main)
    for n, want in ref.saved.items():
        got = scope.get(n)
        assert str(got.dtype).endswith(str(want.dtype)), n
        assert np.array_equal(_words(tio._host_copies({n: got})[n][0]),
                              _words(want)), n
    tol = ORACLE_TOL[("fused_ce", dtype)]["fwd"]
    for f, want in zip(_feeds()[2:], ref.cont):
        got, = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
        assert abs(float(got.ravel()[0]) - want) <= tol * abs(want)


def test_port_f32_checkpoint_loads_into_jax(jax_f32, tmp_path):
    scope = tpt.load_numpy_state(tpt.Scope(), jax_f32.init, device="cpu")
    main, exe, fetch = _port("float32", tpt.Scope())
    feeds = _feeds()
    for f in feeds[:2]:
        exe.run(main, feed=f, fetch_list=fetch, scope=scope)
    with tpt.scope_guard(scope):
        tio.save_persistables(exe, str(tmp_path), main)
    port = [float(exe.run(main, feed=f, fetch_list=fetch,
                          scope=scope)[0].ravel()[0]) for f in feeds[2:]]
    jscope = pt.Scope()
    with pt.core.scope.scope_guard(jscope):
        jio.load_persistables(jax_f32.exe, str(tmp_path), jax_f32.main)
        for n in jax_f32.names:
            assert np.array_equal(np.asarray(jscope.find_var(n)),
                                  _saved_value(tmp_path, n)), n
        jax = [jax_f32.step(f) for f in feeds[2:]]
    for a, b in zip(port, jax):
        assert abs(a - b) <= ORACLE_TOL[("fused_ce", "float32")]["fwd"] \
            * abs(b)


def _saved_value(dirname, name):
    with open(os.path.join(dirname, "__manifest__.pkl"), "rb") as f:
        meta = pickle.load(f)[name]
    return np.load(os.path.join(dirname, meta["file"]))


def test_bf16_files_are_byte_identical(jax_bf16, tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    with pt.core.scope.scope_guard(jax_bf16.scope):
        jio.save_persistables(jax_bf16.exe, str(jdir), jax_bf16.main)
    scope = tpt.load_numpy_state(tpt.Scope(), jax_bf16.state(),
                                 device="cpu")
    main, exe, _ = _port("bfloat16", tpt.Scope())
    with tpt.scope_guard(scope):
        tio.save_persistables(exe, str(tdir), main)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    with open(jdir / "__manifest__.pkl", "rb") as f:
        jman = pickle.load(f)
    with open(tdir / "__manifest__.pkl", "rb") as f:
        tman = pickle.load(f)
    assert jman == tman
    bf16 = [n for n, m in tman.items() if n != "__nprocs__"
            and m["dtype"] == "bfloat16"]
    assert bf16 and "lm_head.w" in bf16
    for name in os.listdir(jdir):
        if name.endswith(".npy"):
            assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), \
                name
    with open(tdir / tman["lm_head.w"]["file"], "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)


def _port_checkpoint(tmp_path):
    scope = tpt.Scope()
    main, exe, _ = _port("float32", scope)
    with tpt.scope_guard(scope):
        tio.save_checkpoint(exe, str(tmp_path), main,
                            train_state={"global_step": 1})
    return main, exe, scope


def test_wrong_crc_and_missing_marker_raise(tmp_path):
    main, exe, scope = _port_checkpoint(tmp_path)
    with tpt.scope_guard(tpt.Scope()):
        tio.load_persistables(exe, str(tmp_path), main)
    path = tmp_path / "lm_head.w.npy"
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 1
    path.write_bytes(bytes(raw))
    with tpt.scope_guard(tpt.Scope()), \
            pytest.raises(IOError, match="checksum mismatch"):
        tio.load_persistables(exe, str(tmp_path), main)
    os.remove(tmp_path / "__done0__")
    with tpt.scope_guard(tpt.Scope()), pytest.raises(IOError,
                                                     match="incomplete"):
        tio.load_persistables(exe, str(tmp_path), main)
    assert not tckpt.checkpoint_complete(str(tmp_path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multiprocess_jax_checkpoint_assembles_densely(dtype, tmp_path,
                                                       monkeypatch):
    """Two JAX processes' writes of one [4, 6] tensor, rows split in two,
    through the JAX package's own writer (its process ids patched)."""
    import ml_dtypes

    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    full = np.arange(24, dtype=np.float32).reshape(4, 6).astype(npdt)
    for proc in (0, 1):
        monkeypatch.setattr(jio, "_multiproc_ids", lambda p=proc: (p, 2))
        rows = slice(2 * proc, 2 * proc + 2)
        snap = jio._ShardedSnap({((rows.start, rows.stop), (0, 6)):
                                 full[rows]}, full.shape, full.dtype, 2,
                                proc)
        jio._write_snapshot(str(tmp_path), {"w": snap})
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()):
        var = main.global_block().create_var(name="w", shape=[4, 6],
                                             dtype=dtype, persistable=True)
    scope = tpt.Scope()
    with tpt.scope_guard(scope):
        tio.load_vars(tpt.Executor(tpt.CPUPlace()), str(tmp_path), main,
                      vars=[var])
    got = scope.get("w")
    assert str(got.dtype) == f"torch.{dtype}"
    assert np.array_equal(got.float().numpy(), full.astype(np.float32))


def test_async_snapshot_is_the_value_at_save(tmp_path):
    """The Executor updates parameters in place: the checkpoint holds the
    state of the moment save() was called, not the next step's."""
    scope = tpt.Scope()
    main, exe, fetch = _port("float32", scope)
    feed = _feeds()[0]
    ck = tio.AsyncCheckpointer()
    with tpt.scope_guard(scope):
        want = {n: scope.numpy(n).copy() for n in ("lm_head.w", "tok_emb.w")}
        ck.save(str(tmp_path), main)
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=fetch)
        ck.close()
    for n, w in want.items():
        assert not np.array_equal(scope.numpy(n), w)
        assert np.array_equal(_saved_value(tmp_path, n), w)


def test_async_errors_surface_on_the_next_save(tmp_path, monkeypatch):
    scope = tpt.Scope()
    main, exe, _ = _port("float32", scope)
    ck = tio.AsyncCheckpointer()
    monkeypatch.setattr(tio, "_write_snapshot", _raise_disk_full)
    with tpt.scope_guard(scope):
        ck.save(str(tmp_path / "a"), main)
        ck._q.join()
        with pytest.raises(RuntimeError, match="disk full"):
            ck.save(str(tmp_path / "b"), main)
    ck.close()


def _raise_disk_full(*_a, **_k):
    raise ValueError("disk full")


def test_inference_model_round_trip(tmp_path):
    scope = tpt.Scope()
    main, exe, _ = _port("float32", scope)
    logits = main.global_block().var("lm_head.tmp_0")
    feed = _feeds()[0]
    with tpt.scope_guard(scope):
        want, = exe.run(tio.get_inference_program([logits], main),
                        feed=feed, fetch_list=[logits])
        tio.save_inference_model(str(tmp_path), ["tokens", "labels"],
                                 [logits], exe, main)
    with tpt.scope_guard(tpt.Scope()):
        prog, feed_names, fetch_vars = tio.load_inference_model(
            str(tmp_path), exe)
        got, = exe.run(prog, feed=feed, fetch_list=fetch_vars)
    assert feed_names == ["tokens", "labels"]
    assert np.array_equal(got, want)


def test_sidecar_across_packages(tmp_path):
    main, exe, scope = _port_checkpoint(tmp_path)
    st = pt.resilience.checkpoint.load_train_state(str(tmp_path))
    assert st["global_step"] == 1
    jkey = {"rng_key": np.array([0, 42], np.uint32)}
    assert tckpt.rng_state_for(jkey, draws_random=False) is None
    with pytest.raises(ValueError, match="not a torch generator state"):
        tckpt.rng_state_for(jkey, draws_random=True)
    state = {"rng_key": np.arange(16, dtype=np.uint8), "rng_kind": "torch"}
    assert np.array_equal(tckpt.rng_state_for(state, True),
                          state["rng_key"])
