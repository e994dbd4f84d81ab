"""The collectives of the mesh paths, with their gradients: the port's
stand-in for what XLA inserts between GSPMD-sharded ops.

Autograd functions (a group of None, or of one rank, is the identity):

  gather(x, dim, group)    all-gather of the ranks' blocks along ``dim``
                           (FSDP's gather over ``data``; the column
                           shards of a cut KV head over ``model``);
                           backward: the reduce-scatter (sum, then this
                           rank's block)
  copy_to(x, group)        identity; backward: all-reduce (sum) — the
                           entry of a tensor-parallel region, whose ranks
                           each send back a partial gradient
  reduce_from(x, group)    all-reduce (sum); backward: identity — the
                           exit of a row-parallel product, the masked
                           embedding lookup, the vocab-parallel softmax
  exchange(x, group)       all-to-all: block i of dim 0 to rank i, the
                           received blocks stacked by sender (the MoE
                           expert-parallel dispatch and its return);
                           backward: the same exchange of the gradient

and their plain counterparts (``all_gather``, ``all_reduce``,
``reduce_scatter``, ``all_reduce_max``, ``all_to_all``) for the paths
without gradients.

Each is the backend's own collective: ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce`` and ``all_to_all_single``.
NCCL carries them where each rank has its own card
(``launch.mesh.launcher_mesh``); gloo where ranks share a card, which
NCCL refuses (phases 3b, 3e, 3q and 3r of ``chip_smoke.py``), and on the
CPU.  torch 2.11's gloo takes the card's f32, bf16, int32 and uint8
tensors in all four (and in ``broadcast``), with the results of their
definitions: probed on an H100 with 2 and 4 ranks sharing it
(``tools/torch_gloo_probe.py``).
Floating sums run in f32 whatever the dtype (a bf16 or f16 tensor is
widened, summed, and rounded once), and every rank of an all-reduce
receives the same bits.  An op that a backend refuses raises from
``torch.distributed``; nothing here falls back.

A ``RecordingGroup`` stands for a group of ranks without a process
group: the dry run (``launch.dryrun``) builds the production meshes of
them and runs rank 0's program.  ``size`` and ``rank`` answer for it
(rank 0 of ``n``), and each collective on it moves nothing: it fills its
result as if every rank held this rank's tensor (a sum is ``n`` times
it, a gather ``n`` copies of it), on the input's device, meta tensors
included, and adds its kind and its result's bytes to the group's
``record`` (the reference's buckets, ``COLLECTIVES``: result-shape bytes
per device in the dtype moved, so a bf16 sum counts its f32 buffer).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_NARROW = (torch.bfloat16, torch.float16)
# torch 2.13 renames the two single-tensor collectives
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


# the reference's collective kinds (``repro.launch.dryrun``'s buckets)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def new_record() -> dict:
    """{"bytes": {kind: 0}, "counts": {kind: 0}} over ``COLLECTIVES``."""
    return {"bytes": dict.fromkeys(COLLECTIVES, 0),
            "counts": dict.fromkeys(COLLECTIVES, 0)}


class RecordingGroup:
    """A group of ``n`` ranks of which this process is rank 0, with no
    process group behind it: its collectives record themselves into
    ``record`` (``new_record``; one record may serve many groups) and fill
    their results as if every rank held this rank's tensor."""

    def __init__(self, n: int, record: dict):
        self.n, self.record = int(n), record

    def note(self, kind: str, out: torch.Tensor) -> None:
        self.record["counts"][kind] += 1
        self.record["bytes"][kind] += out.numel() * out.element_size()

    def __repr__(self) -> str:
        return f"RecordingGroup({self.n})"


def is_group(group) -> bool:
    return isinstance(group, (dist.ProcessGroup, RecordingGroup))


def size(group) -> int:
    if group is None:
        return 1
    if isinstance(group, RecordingGroup):
        return group.n
    return dist.get_world_size(group)


def rank(group) -> int:
    if group is None or isinstance(group, RecordingGroup):
        return 0
    return dist.get_rank(group)


def _reduce_(y: torch.Tensor, op, group) -> None:
    """The backend's in-place all-reduce of ``y`` (contiguous)."""
    if isinstance(group, RecordingGroup):
        group.note("all-reduce", y)
        if op == dist.ReduceOp.SUM:
            y.mul_(group.n)
        return
    dist.all_reduce(y, op=op, group=group)


def _gather_(out: torch.Tensor, flat: torch.Tensor, group) -> None:
    """The backend's gather of every rank's ``flat`` into ``out``."""
    if isinstance(group, RecordingGroup):
        group.note("all-gather", out)
        out.view(group.n, -1).copy_(flat.reshape(1, -1).expand(group.n, -1))
        return
    _all_gather_single(out, flat, group=group)


def _scatter_(out: torch.Tensor, flat: torch.Tensor, group) -> None:
    """The backend's reduce-scatter of every rank's ``flat`` (a sum) into
    this rank's block ``out``."""
    if isinstance(group, RecordingGroup):
        group.note("reduce-scatter", out)
        out.copy_(flat[:out.numel()]).mul_(group.n)
        return
    _reduce_scatter_single(out, flat, group=group)


def _exchange_(out: torch.Tensor, flat: torch.Tensor, group) -> None:
    """The backend's all-to-all of ``flat``'s n blocks into ``out``."""
    if isinstance(group, RecordingGroup):
        group.note("all-to-all", out)
        n = group.n
        out.view(n, -1).copy_(flat.view(n, -1)[:1].expand(n, -1))
        return
    dist.all_to_all_single(out, flat, group=group)


# ------------------------------------------------------------ plain ops
def _summand(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous, narrow floats widened to f32 (a copy, then)."""
    dtype = torch.float32 if x.dtype in _NARROW else x.dtype
    return x.to(dtype, memory_format=torch.contiguous_format)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over the group's ranks, a new tensor
    of ``x``'s dtype; narrow floats are reduced in f32."""
    if size(group) == 1:
        return x
    y = _summand(x)
    if y is x:  # the collective writes in place
        y = x.clone(memory_format=torch.contiguous_format)
    _reduce_(y, op, group)
    return y.to(x.dtype)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    return all_reduce(x, group, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in group
    rank order, bits unchanged."""
    n = size(group)
    if n == 1:
        return x
    dim = dim % x.dim()
    flat = x.contiguous().reshape(-1)
    out = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
    _gather_(out, flat, group)
    shape = x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:]
    return out.reshape((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of the ranks' ``x``
    (narrow floats summed in f32)."""
    n = size(group)
    if n == 1:
        return x
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    y = _summand(x.movedim(dim, 0))
    out = torch.empty(y.numel() // n, dtype=y.dtype, device=y.device)
    _scatter_(out, y.reshape(-1), group)
    block_shape = (x.shape[dim] // n,) + tuple(y.shape[1:])
    return out.reshape(block_shape).movedim(0, dim).to(x.dtype).contiguous()


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The all-to-all of ``x`` (n, ...) over the group's n ranks: block i
    of dim 0 goes to rank i, and block j of the result is what rank j
    sent this rank (``jax.lax.all_to_all`` with split and concat axis 0,
    untiled); bits unchanged."""
    n = size(group)
    if n == 1:
        return x
    if x.shape[0] != n:
        raise ValueError(f"all_to_all of {tuple(x.shape)}: dim 0 must be "
                         f"the group's {n} ranks")
    flat = x.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    _exchange_(out, flat, group)
    return out.reshape(x.shape)


# ------------------------------------------------------ autograd functions
class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if size(group) == 1:
        return x
    return _Gather.apply(x, dim % x.dim(), group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    if size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    if size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    if size(group) == 1:
        return x
    return _Exchange.apply(x, group)
