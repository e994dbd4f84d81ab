"""Mesh builders (the port of ``repro.launch.mesh``).

Functions, not module-level constants, so importing creates no process
group.  The reference's production target is TPU v5e, 256 chips a pod
(16 x 16) and 2 pods for the multi-pod dry-run; here a mesh is a grid of
``torch.distributed`` ranks (``dist.meshctx``).  Axes:

  pod   — FL clients / cross-site data parallelism (the compressed
          aggregation runs over this axis; see ``dist.compress``)
  data  — within-pod data parallelism + ZeRO/FSDP param sharding
  model — tensor parallelism
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist import meshctx


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(sizes, axis names) of the reference's production meshes."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, abstract: bool = False,
                         record: Optional[dict] = None):
    """The production mesh over the world's ranks (256 or 512 of them),
    or, with ``abstract``, its shape alone, against which the rule tables
    resolve without any process group; with ``record``
    (``collectives.new_record``), rank 0 of it on recording groups (the
    dry run: every collective adds itself to ``record``)."""
    sizes, axes = production_mesh_shape(multi_pod=multi_pod)
    if record is not None:
        return meshctx.recording_mesh(sizes, axes, record)
    if abstract:
        return meshctx.Mesh(sizes, axes)
    return meshctx.make_mesh(sizes, axes)


def host_mesh_shape(data: int = 1, model: int = 1, pod: int = 0
                    ) -> Tuple[Sequence[int], Tuple[str, ...]]:
    if pod:
        return (pod, data, model), ("pod", "data", "model")
    return (data, model), ("data", "model")


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0):
    """A small mesh over the world's ranks (tests, examples, the
    launchers): ``(pod, data, model)`` with ``pod``, else ``(data,
    model)``."""
    sizes, axes = host_mesh_shape(data, model, pod)
    return meshctx.make_mesh(sizes, axes)


def launcher_backend(device) -> str:
    """The process group's backend for ranks on ``device``: NCCL where
    each rank of the host can have its own card (``LOCAL_WORLD_SIZE``,
    default ``WORLD_SIZE``, at most the cards there are); else gloo (the
    CPU, or ranks sharing a card, which NCCL refuses)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", "1")))
    if torch.device(device).type == "cuda" and (
            local <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def launcher_mesh(device) -> Tuple[Optional[meshctx.Mesh], torch.device]:
    """Under a launcher that sets ``RANK`` / ``WORLD_SIZE`` (torchrun, with
    ``MASTER_ADDR`` / ``MASTER_PORT``) and more than one rank: join the
    process group (``launcher_backend``) and set a ``make_host_mesh(data=
    world, model=1)`` mesh, as the reference's launchers do over their
    devices.  Returns the mesh (None for a single process) and the rank's
    device: on CUDA, card ``LOCAL_RANK`` modulo the cards there are."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if "RANK" not in os.environ or world == 1:
        return None, device
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(launcher_backend(device),
                                init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=world)
    mesh = make_host_mesh(data=world, model=1)
    meshctx.set_mesh(mesh)
    return mesh, device
