"""Coordination / discovery store — the etcd replacement (the port's
counterpart of ``paddle_tpu/distributed/store.py``; host code, no torch).

Reference: go/pserver/etcd_client.go (Register with TTL lease, PsDesired),
go/master/etcd_client.go (snapshot keys), go/master/inmem_store.go (the
in-memory fake used by tests).  Provides the same tiny KV surface: get /
put / cas / watch-free polling, plus TTL'd ephemeral registration for
service discovery.  InMemStore for in-process tests; FileStore for
multi-process single-host runs (a shared filesystem is the coordination
medium).  A FileStore's files are the JAX package's (one JSON object a key,
``/`` spelled ``__``), so a directory is shared by servers of both
packages."""

import json
import os
import threading
import time


class InMemStore:
    """go/master/inmem_store.go analog."""

    def __init__(self):
        self._data = {}
        self._ttl = {}
        self._lock = threading.Lock()

    def _expire(self):
        now = time.time()
        for k in [k for k, t in self._ttl.items() if t < now]:
            self._data.pop(k, None)
            self._ttl.pop(k, None)

    def put(self, key, value, ttl=None):
        with self._lock:
            self._expire()
            self._data[key] = value
            if ttl:
                self._ttl[key] = time.time() + ttl
            else:
                self._ttl.pop(key, None)

    def get(self, key, default=None):
        with self._lock:
            self._expire()
            return self._data.get(key, default)

    def cas(self, key, expect, value):
        with self._lock:
            self._expire()
            if self._data.get(key) != expect:
                return False
            self._data[key] = value
            return True

    def keys(self, prefix=""):
        with self._lock:
            self._expire()
            return sorted(k for k in self._data if k.startswith(prefix))

    def delete(self, key):
        with self._lock:
            self._data.pop(key, None)
            self._ttl.pop(key, None)


class FileStore:
    """Filesystem-backed store for multi-process runs on one host / NFS."""

    def __init__(self, root):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key):
        return os.path.join(self.root, key.replace("/", "__"))

    def put(self, key, value, ttl=None):
        from ..resilience.retry import retry_call

        meta = {"value": value, "expires": time.time() + ttl if ttl else None}
        tmp = self._path(key) + ".tmp"

        def write():
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, self._path(key))

        # coordination writes ride NFS in multi-host runs: absorb
        # transient IO failures with the shared jittered backoff instead
        # of dropping a heartbeat (a missed TTL refresh deregisters the
        # service and the master re-dispatches its tasks)
        retry_call(write, retries=3, retry_on=(OSError,))

    def get(self, key, default=None):
        try:
            with open(self._path(key)) as f:
                meta = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return default
        if meta["expires"] and meta["expires"] < time.time():
            return default
        return meta["value"]

    def cas(self, key, expect, value):
        # best-effort on a filesystem; adequate for save-model election
        if self.get(key) != expect:
            return False
        self.put(key, value)
        return True

    def keys(self, prefix=""):
        out = []
        for name in os.listdir(self.root):
            if name.endswith(".tmp"):
                continue
            key = name.replace("__", "/")
            if key.startswith(prefix) and self.get(key) is not None:
                out.append(key)
        return sorted(out)

    def delete(self, key):
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


def register_service(store, kind, endpoint, ttl=10):
    """TTL'd ephemeral registration (etcd_client.go:67 Register).  Returns a
    stop() that ends the heartbeat."""
    key = f"services/{kind}/{endpoint}"
    stop_flag = threading.Event()

    def heartbeat():
        while not stop_flag.is_set():
            store.put(key, {"endpoint": endpoint, "ts": time.time()}, ttl=ttl)
            stop_flag.wait(ttl / 3)
        store.delete(key)

    t = threading.Thread(target=heartbeat, daemon=True)
    t.start()
    return stop_flag.set


def discover_services(store, kind):
    return [k.rsplit("/", 1)[1] for k in store.keys(f"services/{kind}/")]
