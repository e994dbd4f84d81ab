"""Async, per-host-sharded checkpointing, in the JAX package's format.

Layout of one checkpoint::

    <dir>/step_<00000042>/
        arrays-00000-of-00002.npz   # shard 0's leaf subset
        arrays-00001-of-00002.npz   # shard 1's leaf subset
        shard-00000.ok              # per-shard landed marker
        shard-00001.ok
        meta.json                   # COMMIT MARKER (atomic, last)

The files, the leaf keys (path components joined by ``$``: dict keys in
sorted order, list and tuple indices) and ``meta.json`` are the JAX
package's (``repro.checkpoint.checkpoint``), so a checkpoint written by
either package restores in the other.

Commit protocol (crash safety):

  1. every shard writes its npz to ``*.tmp`` and ``os.replace``s it into
     place: a crash mid-write never leaves a partial npz under the final
     name;
  2. a shard that landed drops its ``shard-<i>.ok`` marker;
  3. ``meta.json`` (itself tmp + ``os.replace``) is written only once
     **every** marker is present: the commit barrier.  A step directory
     without ``meta.json`` is uncommitted and invisible to
     ``latest_step``; retention GC deletes it.

Sharding: leaves are partitioned over ``num_shards`` hosts by striping
the sorted key list, so no host writes the full state; every host can
compute the full key list from its own (structurally identical) tree,
which is what lets the *last* shard to land perform the commit.

Leaves are torch tensors (any device), numpy arrays or numpy scalars; a
snapshot copies each to host numpy.  ``restore`` places leaves on the
port's device as torch tensors.

Elastic restore: a checkpoint stores whole leaves (host numpy) plus the
mesh axis sizes as metadata.  On a mesh, ``AsyncCheckpointer`` given
``shardings`` (a NamedSharding tree congruent with the state,
``train.steps.train_state_shardings``) gather each leaf from the ranks'
blocks first (a collective: every rank saves), and each rank writes its
stripe of the keys; ``restore(..., shardings=)`` cuts each whole leaf to
this rank's block under the *target* mesh's shardings, so a checkpoint
written on one mesh restores onto another.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

PyTree = Any
_SEP = "$"

__all__ = [
    "save",
    "restore",
    "latest_step",
    "all_steps",
    "garbage_collect",
    "AsyncCheckpointer",
    "CheckpointError",
]


class CheckpointError(RuntimeError):
    """A checkpoint is malformed (truncated, foreign, or incongruent)."""


# ------------------------------------------------------------- flatten
def _flatten_with_path(tree, path=()):
    """(path, leaf) pairs in the JAX package's pytree order: dict keys
    sorted, lists and tuples by index; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def _leaf_key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bf16 leaves have no numpy dtype: cast them "
                            "before saving")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    return {_leaf_key(path): _to_numpy(leaf)
            for path, leaf in _flatten_with_path(tree)}


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in order, from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def shard_keys(keys: Sequence[str], shard_index: int, num_shards: int) -> List[str]:
    """Deterministic leaf partition: stripe the sorted key list.  Every
    host computes the same partition from its own pytree structure."""
    return sorted(keys)[shard_index::num_shards]


# ------------------------------------------------------- write + commit
def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _shard_name(shard_index: int, num_shards: int) -> str:
    return f"arrays-{shard_index:05d}-of-{num_shards:05d}.npz"


def _marker_name(shard_index: int) -> str:
    return f"shard-{shard_index:05d}.ok"


def _write_shard(d: str, arrays: Dict[str, np.ndarray], shard_index: int,
                 num_shards: int) -> None:
    """Write one shard's npz atomically (tmp + replace), then its
    landed marker.  np.savez gets an open handle so it cannot append a
    second .npz suffix to the tmp name."""
    path = os.path.join(d, _shard_name(shard_index, num_shards))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    marker = os.path.join(d, _marker_name(shard_index))
    with open(marker + ".tmp", "w") as f:
        f.write("ok")
    os.replace(marker + ".tmp", marker)


def _all_shards_landed(d: str, num_shards: int) -> bool:
    return all(
        os.path.exists(os.path.join(d, _marker_name(i)))
        for i in range(num_shards)
    )


def _commit(d: str, meta: Dict, shard_index: int = 0) -> None:
    """Atomic commit marker: the checkpoint exists iff meta.json does.
    Two shards landing together may both commit (the same meta): each
    writes its own temporary file."""
    tmp = os.path.join(d, f"meta.json.{shard_index}.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(d, "meta.json"))


def _snapshot(state: PyTree, shardings: Optional[PyTree], shard_index: int,
              num_shards: int) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """(every leaf's key, this shard's stripe of them as host numpy).

    With ``shardings`` each leaf is first gathered whole from the ranks'
    blocks, one leaf at a time and in the same order on every rank (the
    gathers are collectives), and dropped from the device at once unless
    it is in this rank's stripe, whose copy goes to the host: a rank's
    device holds at most one whole leaf beyond its own blocks."""
    pairs = _flatten_with_path(state)
    keys = sorted(_leaf_key(path) for path, _ in pairs)
    mine = set(shard_keys(keys, shard_index, num_shards))
    places = ([ns for _, ns in _flatten_with_path(shardings)]
              if shardings is not None else [None] * len(pairs))
    arrays = {}
    for (path, leaf), ns in zip(pairs, places):
        if ns is not None:
            from repro_torch.dist import sharding

            leaf = sharding.unshard(leaf, ns.spec, ns.mesh)
        key = _leaf_key(path)
        if key in mine:
            arrays[key] = _to_numpy(leaf)
        del leaf
    return keys, arrays


def save(directory: str, step: int, state: PyTree,
         extra: Optional[Dict] = None, *, shard_index: int = 0,
         num_shards: int = 1, mesh_axes: Optional[Dict[str, int]] = None) -> str:
    """Write this host's shard of ``state`` at ``step`` and commit when
    every shard has landed.

    Single-host callers keep the old ``save(dir, step, state)`` shape:
    one shard, written and committed in one call.  Multi-host callers
    each pass their ``shard_index``: whichever host lands last sees all
    markers present and performs the commit, so ``meta.json`` appears
    only after the full state is on disk (the commit barrier).
    """
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    d = _step_dir(directory, step)
    os.makedirs(d, exist_ok=True)
    arrays = _flatten(state)
    keys = sorted(arrays)
    mine = set(shard_keys(keys, shard_index, num_shards))
    _write_shard(d, {k: arrays[k] for k in keys if k in mine},
                 shard_index, num_shards)
    if _all_shards_landed(d, num_shards):
        meta = {
            "step": int(step),
            "keys": keys,
            "num_shards": int(num_shards),
            **({"mesh_axes": {k: int(v) for k, v in mesh_axes.items()}}
               if mesh_axes else {}),
            **(extra or {}),
        }
        _commit(d, meta, shard_index)
    return d


# ------------------------------------------------------------ discovery
def all_steps(directory: str) -> List[int]:
    """Committed steps (meta.json present), ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        # only checkpoints with a committed meta.json count (crash safety)
        if m and os.path.exists(os.path.join(directory, name, "meta.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def read_meta(directory: str, step: int) -> Dict:
    d = _step_dir(directory, step)
    path = os.path.join(d, "meta.json")
    if not os.path.exists(path):
        raise CheckpointError(f"step {step} in {directory} is not committed "
                              f"(no meta.json)")
    with open(path) as f:
        return json.load(f)


def garbage_collect(directory: str, keep_last_k: Optional[int] = None,
                    protect: Sequence[int] = ()) -> List[int]:
    """Delete uncommitted step dirs older than the newest committed step
    (stale partials from a crashed save) and, with ``keep_last_k``,
    committed steps beyond the k newest.  The newest committed step is
    never deleted.  ``protect`` shields in-flight steps an async saver
    has not committed yet.  Returns the deleted step numbers."""
    if not os.path.isdir(directory):
        return []
    committed = all_steps(directory)
    newest = committed[-1] if committed else None
    deleted = []
    for name in sorted(os.listdir(directory)):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m:
            continue
        step = int(m.group(1))
        is_committed = step in committed
        if step in protect:
            continue
        if not is_committed:
            # partial write: only provably-stale ones (older than a
            # committed successor) are safe to reap
            if newest is not None and step < newest:
                shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
                deleted.append(step)
            continue
        if keep_last_k is not None and step not in committed[-keep_last_k:]:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
            deleted.append(step)
    return deleted


# -------------------------------------------------------------- restore
def restore(directory: str, step: int, like: PyTree, device=None,
            shardings: Optional[PyTree] = None) -> PyTree:
    """Restore into the structure of ``like`` (only its structure is
    used) as torch tensors on ``device`` (CUDA unless "cpu" is asked
    for); with ``shardings`` (a congruent NamedSharding tree) each leaf
    is this rank's block of it on the target mesh.

    Raises ``CheckpointError`` when the on-disk keys disagree with
    ``meta.json`` (truncated shard set) or with ``like`` (foreign
    checkpoint), instead of a downstream ``KeyError``.
    """
    device = resolve_device(device)
    d = _step_dir(directory, step)
    meta = read_meta(directory, step)
    num_shards = int(meta.get("num_shards", 1))
    data: Dict[str, np.ndarray] = {}
    for i in range(num_shards):
        path = os.path.join(d, _shard_name(i, num_shards))
        if not os.path.exists(path) and num_shards == 1:
            path = os.path.join(d, "arrays.npz")  # pre-shard layout
        with np.load(path) as npz:  # context manager: handle closed
            for k in npz.files:
                data[k] = npz[k]
    expected = set(meta["keys"])
    got = set(data)
    if got != expected:
        raise CheckpointError(
            f"checkpoint {d} is inconsistent with its meta.json: "
            f"missing keys {sorted(expected - got)[:5]}, "
            f"unexpected keys {sorted(got - expected)[:5]} "
            f"(truncated or foreign checkpoint)"
        )
    paths = [_leaf_key(path) for path, _ in _flatten_with_path(like)]
    want = set(paths)
    if want != expected:
        raise CheckpointError(
            f"checkpoint {d} does not match the restore target: "
            f"checkpoint-only keys {sorted(expected - want)[:5]}, "
            f"target-only keys {sorted(want - expected)[:5]}"
        )
    places = ([ns for _, ns in _flatten_with_path(shardings)]
              if shardings is not None else [None] * len(paths))

    def place(k, ns):
        x = torch.from_numpy(np.array(data[k]))
        if ns is not None:
            from repro_torch.dist import sharding

            x = sharding.shard_tensor(x, ns.spec, ns.mesh)
        return x.to(device)

    return _unflatten(like, iter(place(k, ns) for k, ns in zip(paths, places)))


# ------------------------------------------------------ async checkpointer
class AsyncCheckpointer:
    """Background-thread checkpointer with the commit barrier and
    keep-last-k retention.

    ``save(step, state)`` snapshots this shard's stripe of the state to
    host numpy on the *caller* thread (a consistent cut: the copy of a
    card's tensor waits for the work producing it; with ``shardings``,
    each leaf gathered whole from the mesh's ranks in turn, every rank
    calling, each rank a shard: ``_snapshot``),
    then hands the file I/O to a daemon worker: npz writes, the meta.json
    commit, and retention GC all happen off the training loop.  ``wait()``
    drains the queue; worker failures surface on the next
    ``save``/``wait``.
    """

    def __init__(self, directory: str, *, keep_last_k: Optional[int] = 3,
                 shard_index: int = 0, num_shards: int = 1,
                 mesh_axes: Optional[Dict[str, int]] = None,
                 shardings: Optional[PyTree] = None):
        self.directory = directory
        self.keep_last_k = keep_last_k
        self.shardings = shardings
        if shardings is not None:  # each rank of the mesh writes its stripe
            mesh = _flatten_with_path(shardings)[0][1].mesh
            shard_index, num_shards = mesh.rank, mesh.size
            mesh_axes = mesh_axes or dict(mesh.shape)
        self.shard_index = int(shard_index)
        self.num_shards = int(num_shards)
        self.mesh_axes = dict(mesh_axes) if mesh_axes else None
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._inflight: set = set()
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="async-checkpointer", daemon=True
        )
        self._thread.start()

    # --------------------------------------------------------- worker
    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, keys, arrays, extra = item
                try:
                    d = _step_dir(self.directory, step)
                    os.makedirs(d, exist_ok=True)
                    _write_shard(d, arrays, self.shard_index, self.num_shards)
                    if _all_shards_landed(d, self.num_shards):
                        meta = {"step": int(step), "keys": keys,
                                "num_shards": self.num_shards,
                                **({"mesh_axes": self.mesh_axes}
                                   if self.mesh_axes else {}),
                                **(extra or {})}
                        _commit(d, meta, self.shard_index)
                    with self._lock:
                        self._inflight.discard(step)
                        protect = tuple(self._inflight)
                    garbage_collect(self.directory, self.keep_last_k,
                                    protect=protect)
                except Exception as e:  # noqa: BLE001 -- surfaced to the caller
                    with self._lock:
                        self._inflight.discard(step)
                        self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise CheckpointError("async checkpoint save failed") from err

    # ---------------------------------------------------------- API
    def save(self, step: int, state: PyTree,
             extra: Optional[Dict] = None) -> None:
        """Snapshot now, write in the background."""
        self._raise_pending()
        # device -> host copy of this shard's stripe on the caller
        keys, arrays = _snapshot(state, self.shardings, self.shard_index,
                                 self.num_shards)
        with self._lock:
            self._inflight.add(int(step))
        self._q.put((int(step), keys, arrays, dict(extra) if extra else None))

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every queued save has committed (or failed)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                idle = not self._inflight
            if idle and self._q.unfinished_tasks == 0:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("async checkpoint save did not finish")
            time.sleep(0.005)
        self._raise_pending()

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10.0)
