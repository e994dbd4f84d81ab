"""Process-global mesh context (the port of ``repro.dist.meshctx``).

One mesh per process, three axes:

  pod   — FL clients / cross-site data parallelism; the compressed
          aggregation (``dist.compress``) sums over this axis
  data  — within-pod data parallelism + ZeRO/FSDP param sharding
  model — tensor parallelism

On a TPU the mesh is a grid of devices; here it is a grid of
``torch.distributed`` ranks: the ranks of the default process group
laid out row-major over ``(pod, data, model)``, as ``jax.make_mesh``
lays out devices (rank = (pod * data_size + data) * model_size +
model).  A ``Mesh`` built while a process group is initialised creates
one process group per line of each axis of size > 1 (and per line of
the batch axes ``(pod, data)``), every rank creating every group in the
same order, as ``dist.new_group`` requires; ``group(axis)`` is this
rank's line.  A ``Mesh`` built directly has a shape and no groups: the
rule tables resolve against it (the production shapes, which nothing
here can run).

``default_mesh()`` sizes the axes as the reference does over the world's
ranks: 8 -> (2, 2, 2), 4 -> (2, 1, 2), 2 -> (2, 1, 1), 1 -> (1, 1, 1).
Without a process group it is the one-rank mesh, under which every path
of the port runs as it does on one card.

``manual_axes({...})`` records which mesh axes are currently manual (the
reference's ``shard_map`` regions); ``batch_axes`` subtracts them.  The
reference's ``force_host_device_count`` and ``_backend_initialized`` set
an XLA flag for host devices and have no counterpart: ranks are
processes, started by a launcher or ``torch.multiprocessing``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, FrozenSet, Iterable, Optional, Sequence, Tuple

import torch.distributed as dist

AXES = ("pod", "data", "model")

_mesh: Optional["Mesh"] = None
_manual: FrozenSet[str] = frozenset()


class Mesh:
    """A row-major grid of ranks over named axes.  ``shape`` maps each
    axis name to its size (the reference's ``mesh.shape``); ``rank`` is
    this process's rank in the default group (0 without one)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str] = AXES,
                 *, rank: int = 0, groups: Optional[Dict] = None):
        if len(sizes) != len(axis_names):
            raise ValueError(f"sizes {tuple(sizes)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in sizes)))
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = int(rank)
        self._groups = groups  # axes tuple -> this rank's group; None: abstract

    @property
    def devices_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape[a] for a in self.axis_names)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Each axis's index of ``rank`` (default this rank), row-major."""
        r = self.rank if rank is None else rank
        out = {}
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def coord(self, axes) -> int:
        """This rank's row-major index along ``axes`` (a name or a tuple
        of names, in mesh order)."""
        axes = _axes_tuple(axes)
        c = self.coords()
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes_tuple(axes))

    def line(self, axes, rank: Optional[int] = None) -> list:
        """The ranks that differ from ``rank`` only along ``axes``, in
        row-major order of those axes."""
        axes = _axes_tuple(axes)
        c = self.coords(rank)
        out = []
        for i in range(self.axis_size(axes)):
            cc = dict(c)
            for a in reversed(axes):
                cc[a] = i % self.shape[a]
                i //= self.shape[a]
            r = 0
            for a in self.axis_names:
                r = r * self.shape[a] + cc[a]
            out.append(r)
        return out

    def group(self, axes):
        """This rank's process group along ``axes`` (a name or a tuple in
        mesh order), or None when the axes have size 1.  Raises on an
        abstract mesh."""
        axes = _axes_tuple(axes)
        if self.axis_size(axes) == 1:
            return None
        if self._groups is None:
            raise RuntimeError("an abstract mesh has no process groups")
        if axes not in self._groups:
            raise KeyError(f"no group for axes {axes}; the mesh made "
                           f"{sorted(self._groups)}")
        return self._groups[axes]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _axes_tuple(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


# the axis sets a mesh makes groups for: each axis, and the batch axes
GROUP_AXES = (("pod",), ("data",), ("model",), ("pod", "data"))


def make_mesh(sizes: Sequence[int], axis_names: Sequence[str] = AXES) -> Mesh:
    """A mesh over the ranks of the default process group (its size must
    be the product of ``sizes``), with one group per line of every axis
    set in ``GROUP_AXES`` present in ``axis_names``.  Every rank must call
    it, with the same arguments, in the same order as its other
    ``new_group`` calls.  Without a process group only the one-rank mesh
    can be made."""
    n = math.prod(sizes)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs an initialised "
                               f"process group")
        return Mesh(sizes, axis_names, groups={})
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {tuple(sizes)} holds {n} ranks, the process "
                         f"group {world}")
    mesh = Mesh(sizes, axis_names, rank=dist.get_rank(), groups={})
    for axes in GROUP_AXES:
        if not set(axes) <= set(mesh.axis_names) or mesh.axis_size(axes) == 1:
            continue
        seen = set()
        for r in range(n):  # every line, in the same order on every rank
            line = tuple(mesh.line(axes, r))
            if line in seen:
                continue
            seen.add(line)
            g = dist.new_group(ranks=list(line))
            if mesh.rank in line:
                mesh._groups[axes] = g
    return mesh


def recording_mesh(sizes: Sequence[int], axis_names: Sequence[str] = AXES,
                   record: Optional[dict] = None) -> Mesh:
    """Rank 0 of a mesh of ``sizes`` whose groups are
    ``collectives.RecordingGroup``s sharing ``record``: no process group
    exists, and each collective records its kind and bytes (the dry run,
    ``launch.dryrun``)."""
    from repro_torch.dist import collectives

    record = collectives.new_record() if record is None else record
    mesh = Mesh(sizes, axis_names, rank=0, groups={})
    for axes in GROUP_AXES:
        if set(axes) <= set(mesh.axis_names) and mesh.axis_size(axes) > 1:
            mesh._groups[axes] = collectives.RecordingGroup(
                mesh.axis_size(axes), record)
    return mesh


def default_mesh_shape(n: int) -> Tuple[int, int, int]:
    """The reference's sizing of n ranks: (pod, data, model) as close to
    uniform as n allows."""
    pod = 2 if n % 2 == 0 and n > 1 else 1
    rem = n // pod
    model = 2 if rem % 2 == 0 and rem > 1 else 1
    return pod, rem // model, model


def default_mesh() -> Mesh:
    """A (pod, data, model) mesh over the default process group's ranks,
    or the one-rank mesh without one."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(default_mesh_shape(n))


def set_mesh(mesh: Mesh) -> None:
    global _mesh
    _mesh = mesh


def get_mesh() -> Mesh:
    global _mesh
    if _mesh is None:
        _mesh = default_mesh()
    return _mesh


def active_mesh() -> Optional[Mesh]:
    """The mesh set by ``set_mesh`` or ``use_mesh``, or None: the model
    code reads its groups from here, and runs as on one card without one
    (it never builds the default mesh, whose groups every rank would have
    to create together)."""
    return _mesh


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """``mesh`` as the process's mesh for the duration of the context
    (None leaves the current one): the train step and the engine run the
    model code, which reads ``get_mesh()``, under the mesh they were
    built with."""
    global _mesh
    if mesh is None:
        yield
        return
    prev = _mesh
    _mesh = mesh
    try:
        yield
    finally:
        _mesh = prev


# ------------------------------------------------------------ manual axes
@contextlib.contextmanager
def manual_axes(axes: Iterable[str]):
    """Record ``axes`` as manual for the duration of the context."""
    global _manual
    prev = _manual
    _manual = prev | frozenset(axes)
    try:
        yield
    finally:
        _manual = prev


def get_manual_axes() -> FrozenSet[str]:
    return _manual


# ------------------------------------------------------- axis utilities
def _usable(mesh: Mesh, name: str) -> bool:
    return (
        name in mesh.axis_names
        and mesh.shape[name] > 1
        and name not in _manual
    )


def batch_axes(mesh: Mesh, dim: Optional[int] = None) -> Tuple[str, ...]:
    """Mesh axes a batch dimension shards over: the (pod, data) prefix
    whose size product divides ``dim`` (all of it when ``dim`` is None).
    Size-1 and currently-manual axes are dropped."""
    axes = [a for a in ("pod", "data") if _usable(mesh, a)]
    if dim is None:
        return tuple(axes)
    picked, prod = [], 1
    for a in axes:
        if dim % (prod * mesh.shape[a]) == 0:
            picked.append(a)
            prod *= mesh.shape[a]
        else:
            break
    return tuple(picked)


def model_axis(mesh: Mesh) -> Optional[str]:
    return "model" if _usable(mesh, "model") else None
