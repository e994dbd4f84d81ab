"""Logical-axis -> mesh-axis sharding rules and resolvers (the port of
``repro.dist.sharding``).

Every parameter carries a tuple of *logical* axis names (see
``repro_torch.models.nn.ParamSpec.axes``); a rule table maps each logical
name to zero or more *mesh* axes.  Resolution (``spec_for_axes``) is safe
by construction: a mesh axis is applied only if it exists in the mesh,
has size > 1, divides the dimension, and was not already used by an
earlier dimension of the same tensor — otherwise that dimension stays
replicated, so one rule table serves every architecture and mesh shape.

Rule tables (the reference's, verbatim)
  PARAM_RULES          — training default: ZeRO/FSDP over 'data' on the
                         embed dim, tensor parallelism over 'model'
  EP_PARAM_RULES       — MoE expert parallelism: experts over 'model'
                         (full d_ff per expert shard), FSDP kept
  NO_FSDP_RULES        — model-only sharding; compressed multi-pod steps
                         use this so per-pod gradient tensors are whole
                         along the summed (integer message) dimension
  SERVE_RESIDENT_RULES — serving: weights resident (no ZeRO gather),
                         tensor parallelism only
  ACT_RULES            — the reference's activation constraints
                         (``nn.shard_activation``); the port's activation
                         layout is explicit in the model code

What GSPMD did for the reference is explicit here: ``shard_tensor`` cuts
a whole tensor to this rank's block under a spec, ``unshard`` gathers the
blocks back (a collective: every rank of the mesh calls it), and
``reduce_scatter`` sums a whole tensor over the spec's axes and keeps this
rank's block.  A spec entry naming several axes splits the dimension
row-major over them, as a ``PartitionSpec`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.dist import collectives, meshctx
from repro_torch.dist.meshctx import Mesh

Rules = Tuple[Tuple[str, Union[None, str, Tuple[str, ...]]], ...]

PARAM_RULES: Rules = (
    ("layers", None),
    ("embed", "data"),  # ZeRO/FSDP
    ("heads", "model"),
    ("kv", "model"),
    ("mlp", "model"),
    ("vocab", "model"),
    ("vocab_in", "model"),
    ("expert", None),
)

EP_PARAM_RULES: Rules = (
    ("layers", None),
    ("embed", "data"),
    ("heads", "model"),
    ("kv", "model"),
    ("mlp", None),  # full d_ff per expert shard
    ("vocab", "model"),
    ("vocab_in", "model"),
    ("expert", "model"),  # experts over the model axis (all_to_all dispatch)
)

NO_FSDP_RULES: Rules = (
    ("layers", None),
    ("embed", None),
    ("heads", "model"),
    ("kv", "model"),
    ("mlp", "model"),
    ("vocab", "model"),
    ("vocab_in", "model"),
    ("expert", None),
)

# Serving: same placement as NO_FSDP (resident weights, TP only) — a
# distinct name because train-time gather_once and the serve launcher
# key off it and may diverge from the compressed-train table later.
SERVE_RESIDENT_RULES: Rules = NO_FSDP_RULES

ACT_RULES: Rules = (
    ("batch", ("pod", "data")),
    ("embed", None),
    ("heads", "model"),
    ("kv", "model"),
    ("mlp", "model"),
    ("vocab", "model"),
    ("expert", None),
)


class P(tuple):
    """A partition spec: one entry per dimension, None (replicated), a
    mesh axis name, or a tuple of names (the reference's
    ``PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Mesh
    spec: P


def _axes_tuple(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def spec_for_axes(
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh: Mesh,
    rules: Rules,
) -> P:
    """Resolve one tensor's logical axes to a spec under ``rules``,
    applying only mesh axes that exist, have size > 1, divide the
    dimension, and are unused so far in this spec."""
    table = dict(rules)
    used = set()
    out = []
    for dim, name in zip(shape, logical_axes):
        picked, prod = [], 1
        for a in _axes_tuple(table.get(name) if name is not None else None):
            if (
                a in mesh.axis_names
                and mesh.shape[a] > 1
                and a not in used
                and dim % (prod * mesh.shape[a]) == 0
            ):
                picked.append(a)
                prod *= mesh.shape[a]
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return P(*out)


def _is_param_spec(x: Any) -> bool:
    return hasattr(x, "axes") and hasattr(x, "shape") and hasattr(x, "init")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_shardings(pspecs: Any, mesh: Mesh, rules: Rules) -> Any:
    """NamedSharding tree for a ParamSpec tree under a rule table."""
    def one(s):
        if not _is_param_spec(s):
            raise TypeError(f"not a ParamSpec: {type(s).__name__}")
        return NamedSharding(mesh, spec_for_axes(s.axes, s.shape, mesh, rules))

    return _map(one, pspecs)


def batch_spec(mesh: Mesh, ndim: int, batch_dim: int) -> P:
    """Spec for a batch-leading tensor: dim 0 over the largest (pod, data)
    prefix dividing ``batch_dim``, other dims replicated."""
    axes = meshctx.batch_axes(mesh, batch_dim)
    first: Any = None
    if len(axes) == 1:
        first = axes[0]
    elif axes:
        first = axes
    return P(first, *([None] * (ndim - 1)))


# ----------------------------------------------- placement (GSPMD's work)
def _entries(spec: P, axes: Optional[Iterable[str]]):
    """(dim, mesh axes) of each sharded dim, keeping only ``axes`` when
    given (an entry keeps its leading axes that are in ``axes``)."""
    keep = None if axes is None else set(axes)
    for dim, entry in enumerate(spec):
        names = _axes_tuple(entry)
        if keep is not None:
            names = tuple(a for a in names if a in keep)
        if names:
            yield dim, names


def shard_shape(shape: Sequence[int], spec: P, mesh: Mesh,
                axes: Optional[Iterable[str]] = None) -> Tuple[int, ...]:
    """The block shape of a tensor of ``shape`` under ``spec`` (only the
    mesh axes in ``axes``, when given)."""
    out = list(shape)
    for dim, names in _entries(spec, axes):
        out[dim] //= mesh.axis_size(names)
    return tuple(out)


def shard_tensor(full: torch.Tensor, spec: P, mesh: Mesh,
                 axes: Optional[Iterable[str]] = None) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (only the mesh axes in
    ``axes``, when given), a contiguous copy that holds no more than the
    block (a block of leading rows is a contiguous view of the whole
    storage, which ``contiguous()`` would keep alive); ``full`` itself
    where the spec splits nothing."""
    out = full
    for dim, names in _entries(spec, axes):
        n = mesh.axis_size(names)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"split over {names} ({n} ranks)")
        b = out.shape[dim] // n
        out = out.narrow(dim, mesh.coord(names) * b, b)
    if out is full:
        return full
    return out.clone(memory_format=torch.contiguous_format)


def unshard(local: torch.Tensor, spec: P, mesh: Mesh,
            axes: Optional[Iterable[str]] = None) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec`` (gathered
    over the mesh axes in ``axes``, when given): a collective."""
    out = local
    for dim, names in _entries(spec, axes):
        out = collectives.all_gather(out, dim, mesh.group(names))
    return out


def reduce_scatter(full: torch.Tensor, spec: P, mesh: Mesh,
                   axes: Optional[Iterable[str]] = None) -> torch.Tensor:
    """This rank's block, under ``spec``, of the sum over the spec's mesh
    axes (those in ``axes``, when given) of every rank's ``full``."""
    out = full
    for dim, names in _entries(spec, axes):
        out = collectives.reduce_scatter(out, dim, mesh.group(names))
    return out


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Every leaf of a whole tree (dicts, lists, tuples) cut to this
    rank's block under the congruent NamedSharding tree."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s) for v, s in zip(tree, shardings))
    return shard_tensor(tree, shardings.spec, shardings.mesh)


def tree_leaves(shardings: Any) -> list:
    """The NamedShardings of a tree in the pytree order of its leaves
    (dict keys sorted; lists and tuples by index)."""
    if isinstance(shardings, dict):
        return [x for k in sorted(shardings)
                for x in tree_leaves(shardings[k])]
    if isinstance(shardings, (list, tuple)):
        return [x for v in shardings for x in tree_leaves(v)]
    return [shardings]


def spec_axes(spec: P) -> set:
    """The mesh axes a spec shards over."""
    return {a for _, names in _entries(spec, None) for a in names}
