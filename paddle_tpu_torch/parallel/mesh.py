"""Device mesh construction (``paddle_tpu/parallel/mesh.py``).

The port runs one process per rank.  A :class:`Mesh` is the ranks laid
out on named axes (major..minor); it needs no process group, so the spec
rules of ``api.py`` and :func:`axis_size` work on it in one process.
Once ``torch.distributed`` is initialised, :meth:`Mesh.bind` makes the
process groups of this rank's axes (every rank must call it, in the same
order: the executor does, at construction), and :meth:`Mesh.device_mesh`
wraps the same layout as a ``torch.distributed.device_mesh.DeviceMesh``
for DTensor code (a collective call too).

Axis-name conventions used across the framework:
  dp — data parallel (batch axis)        sp — sequence/context parallel
  fsdp — parameter sharding (ZeRO-3)     ep — expert parallel (reserved)
  tp — tensor/model parallel             pp — pipeline (reserved)
"""

import numpy as np

__all__ = ["Mesh", "make_mesh", "axis_size", "single_host_mesh"]

# process groups by (ranks, backend), shared by every mesh of the process
# group: a group is made once (collectively) however many meshes use it
_GROUPS = {}


class Mesh:
    """Ranks on named axes: ``devices`` is an ndarray of rank ids whose
    dims are the axes (the ``jax.sharding.Mesh`` attributes the spec
    rules read: ``axis_names``, ``devices.shape``, ``shape``)."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh of rank {self.devices.ndim} for axes "
                f"{self.axis_names}")
        self._groups = {}
        self._rank = None
        self._backend = None

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def coords(self, rank):
        """``{axis: index}`` of ``rank`` on the mesh."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not on the mesh {self}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def all_groups(self, axis):
        """Every group of ``axis`` (a name, or a tuple of names: the ranks
        that differ only along those axes): its ranks, one list for each
        coordinate of the other axes."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        ks = [self.axis_names.index(a) for a in axes]
        arr = np.moveaxis(self.devices, ks, list(range(-len(ks), 0)))
        k = int(np.prod([self.devices.shape[i] for i in ks]))
        return [[int(r) for r in row] for row in arr.reshape(-1, k)]

    def bind(self, rank, backend=None):
        """Make the process groups of every axis of size > 1 (all ranks
        call this in the same order; a group another mesh made already is
        reused) and keep this rank's; returns self.
        Needs ``torch.distributed`` initialised with the mesh's size."""
        import torch.distributed as dist

        if dist.get_world_size() != self.size:
            raise ValueError(
                f"mesh {self.shape} has {self.size} ranks, the process "
                f"group {dist.get_world_size()}")
        self._rank = int(rank)
        self._backend = backend
        for axis in self.axis_names:
            if self.shape[axis] > 1:
                self.group(axis)
        return self

    def group(self, axis):
        """This rank's process group along ``axis`` (a name, or a tuple of
        names), after :meth:`bind`.  A group of several axes is made at its
        first use: every rank must ask for it, in the same order."""
        import torch.distributed as dist

        axes = axis if isinstance(axis, tuple) else (axis,)
        axes = tuple(a for a in axes if self.shape[a] > 1)
        if len(axes) == 1:
            axes = axes[0]
        mine = self._groups.get(axes)
        if mine is not None:
            return mine
        if self._rank is None:
            raise RuntimeError(f"{self}: bind() it to a rank first")
        n = int(np.prod([self.shape[a] for a in
                         (axes if isinstance(axes, tuple) else (axes,))]))
        if n == self.size:
            mine = dist.group.WORLD
        else:
            for ranks in self.all_groups(axes):
                key = (tuple(ranks), self._backend)
                g = _GROUPS.get(key)
                if g is None:
                    g = _GROUPS[key] = dist.new_group(
                        ranks, backend=self._backend)
                if self._rank in ranks:
                    mine = g
        self._groups[axes] = mine
        return mine

    def device_mesh(self, device_type):
        """The same layout as a ``DeviceMesh`` (collective: every rank
        calls it)."""
        from torch.distributed.device_mesh import DeviceMesh

        return DeviceMesh(device_type, self.devices.tolist(),
                          mesh_dim_names=self.axis_names)

    def __repr__(self):
        return f"Mesh({self.shape})"


def _default_count():
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
    except ImportError:  # pragma: no cover
        pass
    return None


def make_mesh(axes, devices=None):
    """axes: dict name->size in the desired (major..minor) order, e.g.
    {'dp': 4, 'tp': 2}.  ``devices`` are rank ids (default: the process
    group's ranks, else as many as the sizes multiply to).  Sizes must
    multiply to the rank count; a size of -1 is inferred."""
    names = list(axes.keys())
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if devices is None:
        n = _default_count()
        if n is None:
            if -1 in sizes:
                raise ValueError(
                    "a -1 mesh axis needs devices= or an initialised "
                    "process group")
            n = int(np.prod(sizes))
        devices = list(range(n))
    devices = list(devices)
    n = len(devices)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if known == 0 or n % known:
            raise ValueError(
                f"{n} devices not divisible by known axes {known}")
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    return Mesh(np.asarray(devices).reshape(sizes), names)


def axis_size(mesh, name):
    """Size of a named mesh axis, 0 when the mesh lacks it (or is None) —
    the guard every dp-conditional path uses (ZeRO sharding, the
    comm-aware accumulation loop) without special-casing meshless runs."""
    if mesh is None:
        return 0
    try:
        return int(dict(zip(mesh.axis_names, mesh.devices.shape))[name])
    except KeyError:
        return 0


def single_host_mesh(dp=-1, tp=1, sp=1):
    """Convenience: all ranks in a dp×tp×sp mesh (dp inferred)."""
    axes = {"dp": dp, "tp": tp, "sp": sp}
    axes = {k: v for k, v in axes.items() if v != 1 or k == "dp"}
    return make_mesh(axes)
