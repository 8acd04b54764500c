"""Full-state checkpoint manifest — what the persistables snapshot alone
cannot carry.  The port's own copy of
``paddle_tpu/resilience/checkpoint.py``: the same file, the same schema
v1, one field more (``rng_kind``).

``io.save_persistables`` captures params + optimizer state, but a killed
trainer also loses its RNG key (the ``@RNG@`` scope var the executor
splits per step), its reader cursor (how many batches of the current
pass were consumed), and its pass/step counters — without them a resume
replays different dropout masks on different data and the trajectory
forks.  This module adds the schema-versioned *train-state* sidecar
(``__train_state__.pkl``) that rides inside every full-state checkpoint
directory, plus discovery (``latest_checkpoint`` honoring the
crash-publish ``.old`` fallback) and retention (``prune_checkpoints``).

Schema v1 fields::

    schema_version   1
    global_step      completed optimizer steps across all passes
    pass_id          the pass the checkpoint was taken in
    step_in_pass     batches completed within that pass
    rng_key          the @RNG@ state AFTER step ``global_step`` —
                     restoring it replays the exact per-step dropout
                     draws.  The JAX package writes its threefry key
                     (uint32 ndarray); the port writes the state of its
                     ``torch.Generator`` (Philox on the card), a uint8
                     ndarray, and says so in ``rng_kind``
    rng_kind         ``"torch"`` when ``rng_key`` is a torch generator
                     state; absent in the JAX package's sidecars
    rng_seed         program.random_seed the key chain started from
    reader_state     resumable-reader cursor (``{"items": n}`` or the
                     underlying reader's own snapshot)
    num_passes       the train() call's pass budget (sanity check)
    time             wall-clock save time (informational only)

Unknown *newer* schema versions refuse to load (forward compatibility is
an explicit decision, not an accident); missing fields of older versions
default conservatively.

The two packages' generators cannot stand in for each other: a threefry
key is no Philox state.  ``rng_state_for`` gives a resume the state to
restore and raises on a JAX key — unless the program draws no random
numbers, where there is nothing to restore and the key is skipped.  It
never re-seeds quietly.  The JAX package's ``load_train_state`` returns
the sidecar's fields as they are and ignores ``rng_kind``, but its
``Trainer`` does not look at the kind either: resuming a port checkpoint
there sets the torch state as its threefry ``@RNG@`` key, which only a
program that draws no random numbers survives.  Across packages, carry
the tensors (``io.load_persistables``), not the train state.
"""

import os
import pickle
import re
import time

import numpy as np

__all__ = [
    "SCHEMA_VERSION", "STATE_FILE", "save_train_state",
    "load_train_state", "has_train_state", "checkpoint_complete",
    "latest_checkpoint", "prune_checkpoints", "step_dir", "RNG_KIND",
    "rng_state_for",
]

SCHEMA_VERSION = 1
RNG_KIND = "torch"
STATE_FILE = "__train_state__.pkl"
_STEP_RE = re.compile(r"^step_(\d+)$")


def step_dir(checkpoint_dir, global_step):
    """Canonical per-step checkpoint directory name."""
    return os.path.join(checkpoint_dir, f"step_{int(global_step)}")


def save_train_state(dirname, state):
    """Write the train-state sidecar into ``dirname`` (which must
    already exist — callers write it into the checkpoint dir before the
    completion markers / atomic publish, so a complete checkpoint always
    carries it)."""
    out = dict(state)
    out.setdefault("schema_version", SCHEMA_VERSION)
    out.setdefault("time", time.time())
    with open(os.path.join(dirname, STATE_FILE), "wb") as f:
        pickle.dump(out, f)


def load_train_state(dirname):
    """Read the sidecar, honoring the crash-publish ``.old`` fallback
    the same way ``io.load_vars`` does (a crash between the two publish
    renames leaves the last good checkpoint at ``<dirname>.old``).
    Raises ``FileNotFoundError`` when neither location has one, and
    ``ValueError`` on a schema from the future."""
    path = os.path.join(dirname, STATE_FILE)
    if not os.path.exists(path):
        alt = os.path.join(dirname + ".old", STATE_FILE)
        if os.path.exists(alt):
            path = alt
        else:
            raise FileNotFoundError(
                f"no {STATE_FILE} in {dirname} (or its .old fallback) — "
                f"not a full-state checkpoint")
    with open(path, "rb") as f:
        state = pickle.load(f)
    ver = state.get("schema_version", 0)
    if ver > SCHEMA_VERSION:
        raise ValueError(
            f"checkpoint train-state schema v{ver} is newer than this "
            f"build understands (v{SCHEMA_VERSION}) — upgrade before "
            f"resuming from {path}")
    return state


def has_train_state(dirname):
    return (os.path.exists(os.path.join(dirname, STATE_FILE))
            or os.path.exists(os.path.join(dirname + ".old", STATE_FILE)))


def _complete_at(dirname):
    """A published snapshot lives at exactly ``dirname``: manifest
    present and every writer's completion marker in place."""
    manifest = os.path.join(dirname, "__manifest__.pkl")
    if not os.path.exists(manifest):
        return False
    try:
        with open(manifest, "rb") as f:
            nprocs = pickle.load(f).get("__nprocs__", 1)
    except Exception:
        return False  # torn manifest write
    return all(
        os.path.exists(os.path.join(dirname, f"__done{p}__"))
        for p in range(nprocs))


def checkpoint_complete(dirname, require_state=False):
    """Is ``dirname`` a loadable checkpoint — directly, or via its
    ``.old`` crash-publish fallback (the load_vars recovery path)?"""
    ok = _complete_at(dirname) or _complete_at(dirname + ".old")
    if ok and require_state:
        ok = has_train_state(dirname)
    return ok


def latest_checkpoint(checkpoint_dir, require_state=True):
    """The highest-step loadable ``step_<n>`` checkpoint under
    ``checkpoint_dir`` (None when there is none).  Torn directories — a
    leftover ``.tmp``, missing completion markers from a writer killed
    mid-save — are skipped, falling back to the next older step; a
    crash between the publish renames is honored via ``.old``."""
    if not os.path.isdir(checkpoint_dir):
        return None
    steps = {}
    for name in os.listdir(checkpoint_dir):
        base = name[:-4] if name.endswith(".old") else name
        m = _STEP_RE.match(base)
        if m:
            steps[int(m.group(1))] = os.path.join(checkpoint_dir, base)
    for n in sorted(steps, reverse=True):
        if checkpoint_complete(steps[n], require_state=require_state):
            return steps[n]
    return None


def prune_checkpoints(checkpoint_dir, keep=3):
    """Best-effort retention: delete ``step_<n>`` directories (and their
    ``.tmp``/``.old`` companions) beyond the ``keep`` highest steps.
    Never touches the ``keep`` most recent — with
    ``AsyncCheckpointer(max_pending=2)`` and ``keep >= 2`` a pruned step
    is always fully written (the bounded queue means at most the two
    newest saves can still be in flight).  Returns the pruned paths."""
    import shutil

    if keep < 2:
        raise ValueError(
            f"keep must be >= 2 (the async write queue can hold the two "
            f"newest saves in flight): {keep}")
    if not os.path.isdir(checkpoint_dir):
        return []
    steps = {}
    for name in os.listdir(checkpoint_dir):
        base = name
        for suffix in (".old", ".tmp"):
            if base.endswith(suffix):
                base = base[: -len(suffix)]
        m = _STEP_RE.match(base)
        if m:
            steps.setdefault(int(m.group(1)), set()).add(
                os.path.join(checkpoint_dir, name))
    pruned = []
    for n in sorted(steps, reverse=True)[keep:]:
        for path in sorted(steps[n]):
            try:
                shutil.rmtree(path)
                pruned.append(path)
            except OSError:
                pass  # retention is best-effort; next save retries
    return pruned


def rng_state_for(state, draws_random):
    """The ``@RNG@`` value a resume restores from the sidecar ``state``:
    the torch generator state as a uint8 ndarray, or None when the
    sidecar holds no key.  A key of another kind (the JAX package's
    threefry key) raises, unless ``draws_random`` is False — a program
    with no random op has no stream to continue, and the key is
    skipped."""
    key = state.get("rng_key")
    if key is None:
        return None
    kind = state.get("rng_kind")
    if kind == RNG_KIND:
        return np.asarray(key, np.uint8)
    if not draws_random:
        return None
    raise ValueError(
        f"the checkpoint's RNG key is of kind {kind or 'jax threefry'!r}, "
        f"not a torch generator state; this program draws random numbers "
        f"(dropout), and a resume from another package's key would fork "
        f"the trajectory — resume it in the package that wrote it")
